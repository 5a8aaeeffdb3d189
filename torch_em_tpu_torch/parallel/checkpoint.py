"""Sharded checkpoints of a process group's training state.

Counterpart of ``torch_em_tpu/parallel/checkpoint.py`` on
``torch.distributed.checkpoint``: ``save_sharded_checkpoint`` is collective
over the process group, and each process writes its own part (a tensor that
every process holds alike is written once); ``restore_sharded_checkpoint``
reads the parts into a tree shaped like ``like``, on the devices of its
leaves or of the mesh. Without a process group one process writes and reads
everything. The format is the port's own: the JAX package's orbax and
msgpack checkpoints are not read.
"""

import os
from typing import Any

import torch

__all__ = ["save_sharded_checkpoint", "restore_sharded_checkpoint"]


def save_sharded_checkpoint(path: str, tree: Any) -> str:
    """Save a (nested) dict of tensors and plain values to the directory ``path``; returns
    the path written."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(str(path))
    dcp.save(tree, checkpoint_id=path)
    return path


def _empty_like(tree, device):
    if isinstance(tree, dict):
        return {k: _empty_like(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device=tree.device if device is None else device)
    return tree


def restore_sharded_checkpoint(path: str, like: Any, mesh=None) -> Any:
    """A tree shaped like ``like`` (a nested dict of tensors and plain values; ``like`` itself
    is left as it is) filled from the checkpoint at ``path``. Each tensor lands on the device
    of its leaf in ``like`` or, with a ``mesh``, on this process's device of the mesh."""
    import torch.distributed.checkpoint as dcp

    device = None
    if mesh is not None:
        device = torch.device(mesh.device_type, torch.cuda.current_device()) if mesh.device_type == "cuda" \
            else torch.device(mesh.device_type)
    state = _empty_like(like, device)
    dcp.load(state, checkpoint_id=os.path.abspath(str(path)))
    return state
