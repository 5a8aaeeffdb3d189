"""Process groups and device meshes: one process per device.

Counterpart of ``torch_em_tpu/parallel/mesh.py``. The JAX package drives
every device of a host from one process over a ``jax.sharding.Mesh``; the
port follows torch-em's model (``multi_gpu_training.py``): one process per
device, joined in a ``torch.distributed`` process group, where a global
quantity (a gradient, a batch statistic, a loss) is formed by collectives.

``init_process_group`` joins the group from an explicit ``init_method``
(``file://`` of a path in a temporary directory avoids the races for a free
port that ``tcp://`` has when several runs start at once). The backend is
NCCL for a CUDA device and gloo for the CPU unless the caller names one:
gloo also joins several processes that share one card, which NCCL refuses.
``get_mesh`` lays the group out as a ``DeviceMesh`` with named axes,
``replicate`` copies rank 0's parameters, buffers and optimizer state to
every process, and ``shard_batch`` takes this process's part of a batch.
"""

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models.base import resolve_device

__all__ = ["init_process_group", "get_mesh", "replicate", "shard_batch", "default_backend", "rank_device"]


def default_backend(device: Union[str, torch.device]) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(rank: int, device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device of process ``rank``: the CPU, or card ``rank`` modulo the cards present
    (so several processes may share one card)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_process_group(init_method: str, world_size: int, rank: int,
                       device: Union[str, torch.device] = "cuda", backend: Optional[str] = None) -> torch.device:
    """Join this process to a group of ``world_size`` as ``rank``; returns its device.

    ``backend`` defaults to ``default_backend(device)``. On a CUDA device the process's
    current device becomes ``rank_device(rank, device)``."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or default_backend(dev), init_method=init_method,
                            world_size=world_size, rank=rank)
    return dev


def _comm_device(group=None) -> str:
    """Where a group's collectives take their tensors: the card under NCCL, the host under gloo."""
    return "cuda" if dist.get_backend(group) == "nccl" else "cpu"


def get_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
             shape: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A mesh over the process group: 1-D ``("data",)`` by default, or of ``shape`` with one
    name per axis (``(2, 2)`` with ``("data", "space")``, say). One process per device, so
    ``n_devices``, when given, must be the group's size."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} processes, one per device")
    axis_names = tuple(axis_names)
    shape = (world,) + (1,) * (len(axis_names) - 1) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} with axes {axis_names} does not cover {world} processes")
    return init_device_mesh(_comm_device(), shape, mesh_dim_names=axis_names)


def _axis_group(mesh: Optional[DeviceMesh], axis: Optional[str]):
    """(group, size, this process's index) of a mesh axis; the whole group without a mesh."""
    if mesh is None or axis is None:
        return None, dist.get_world_size(), dist.get_rank()
    return mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)


@torch.no_grad()
def replicate(module: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None, src: int = 0):
    """Copy rank ``src``'s parameters and buffers, and the optimizer's state tensors, to every
    process of the group (in place); returns the module."""
    tensors = list(module.state_dict().values())
    if optimizer is not None:
        for state in optimizer.state.values():
            tensors += [v for v in state.values() if isinstance(v, torch.Tensor)]
    for t in tensors:
        dist.broadcast(t, src)
    return module


def _shard(t, n: int, i: int):
    b = t.shape[0]
    per = -(-b // n)
    # a batch that does not divide the processes repeats its samples from the first on
    idx = np.arange(i * per, (i + 1) * per) % b
    if isinstance(t, torch.Tensor):
        return t[torch.from_numpy(idx).to(t.device)]
    return np.asarray(t)[idx]


def shard_batch(batch, mesh: Optional[DeviceMesh] = None, axis: str = "data"):
    """This process's slice of the leading axis of a batch (an array or tensor, or a tuple or
    list of them) along the mesh ``axis`` (without a mesh: among all processes). A batch that
    does not divide the processes is padded by repeating its samples, as the JAX package's
    data-parallel trainer pads a ragged batch."""
    _, n, i = _axis_group(mesh, axis)
    if isinstance(batch, (tuple, list)):
        return type(batch)(_shard(t, n, i) for t in batch)
    return _shard(batch, n, i)
