"""Carry U-Net weights from the JAX package's flax variables into the port.

The port keeps its own copy of the mapping in
``torch_em_tpu/utils/modelzoo.py:torch_state_dict_from_flax``: flax block
``encoder<i>`` / ``base`` / ``decoder<i>`` with convs ``conv0`` and ``conv1``
becomes torch-em's ``encoder.blocks.<i>.block.{1,4}`` (``{0,2}`` without a
norm), ``sampler<i>/conv`` becomes ``decoder.samplers.<i>.conv``, and
``out_conv`` stays (``out_conv<i>`` of a model with side outputs becomes
``out_conv.<i>``). Conv kernels go from (*kernel, I, O) to (O, I, *kernel);
the upsamplers' and the output's 1x1 convs are flax ``Dense`` layers with an
(I, O) kernel and become (O, I, 1, ..., 1). A block's norms ``norm0`` and
``norm1`` sit at ``block.{0,3}``: the ``scale`` and ``bias`` of their flax
child (``GroupNorm_0``, ``BatchNorm_0``, ``_InstanceNormTrackStats_0``)
become ``weight`` and ``bias``, and the ``mean`` and ``var`` of the
``batch_stats`` collection ``running_mean`` and ``running_var``.
"""

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["state_dict_from_jax_params"]


def _conv_weight(kernel: np.ndarray, spatial_rank: int) -> np.ndarray:
    kernel = np.asarray(kernel, dtype=np.float32)
    if kernel.ndim == 2:  # dense 1x1: (I, O) -> (O, I, 1, ..., 1)
        return kernel.T.reshape(kernel.shape[::-1] + (1,) * spatial_rank)
    if kernel.ndim != spatial_rank + 2:
        raise ValueError(f"kernel of rank {kernel.ndim} in a {spatial_rank}D model")
    rank = kernel.ndim
    return kernel.transpose((rank - 1, rank - 2) + tuple(range(rank - 2)))


def state_dict_from_jax_params(
    flat: Dict[str, np.ndarray], norm: Optional[str] = "InstanceNorm",
    batch_stats: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, torch.Tensor]:
    """Map a flax U-Net's ``params`` tree, flattened to ``/``-joined keys, onto the port's state dict.

    ``norm`` is the model's norm: it decides whether the convs of a block
    sit at ``block.{1,4}`` (behind norms) or ``block.{0,2}`` (no norm), and
    which norm parameters there are. ``batch_stats`` is the flattened
    ``batch_stats`` collection of a model with ``"BatchNorm"`` or
    ``"InstanceNormTrackStats"``.
    """
    if norm not in (None, "InstanceNorm", "InstanceNormTrackStats", "GroupNorm", "BatchNorm"):
        raise ValueError(f"Invalid norm: {norm!r}")
    tracked = norm in ("BatchNorm", "InstanceNormTrackStats")
    if tracked and not batch_stats:
        raise ValueError(f"norm={norm!r} needs the model's batch_stats")
    conv_idx = (0, 2) if norm is None else (1, 4)
    spatial_rank = max(np.ndim(v) for v in flat.values()) - 2

    def grouped(tree):
        groups = {}
        for key, value in (tree or {}).items():
            top, rest = key.split("/", 1)
            groups.setdefault(top, {})[rest] = value
        return groups

    groups, stats = grouped(flat), grouped(batch_stats)
    state = {}

    def leaf(tree, j, name):
        """The ``name`` leaf of the j-th norm's flax child in a block's flattened tree."""
        found = [v for k, v in tree.items() if k.startswith(f"norm{j}/") and k.endswith(f"/{name}")]
        if len(found) != 1:
            raise ValueError(f"expected one norm{j}/*/{name}, found {len(found)}")
        return found[0]

    def block(src, dst):
        params = groups.pop(src)
        for j in range(2):
            state[f"{dst}.block.{conv_idx[j]}.weight"] = _conv_weight(
                params[f"conv{j}/kernel"], spatial_rank)
            state[f"{dst}.block.{conv_idx[j]}.bias"] = params[f"conv{j}/bias"]
            if norm not in (None, "InstanceNorm"):
                state[f"{dst}.block.{3 * j}.weight"] = leaf(params, j, "scale")
                state[f"{dst}.block.{3 * j}.bias"] = leaf(params, j, "bias")
            if tracked:
                state[f"{dst}.block.{3 * j}.running_mean"] = leaf(stats[src], j, "mean")
                state[f"{dst}.block.{3 * j}.running_var"] = leaf(stats[src], j, "var")

    n_levels = len([k for k in groups if k.startswith("encoder")])
    for i in range(n_levels):
        block(f"encoder{i}", f"encoder.blocks.{i}")
        block(f"decoder{i}", f"decoder.blocks.{i}")
        sampler = groups.pop(f"sampler{i}")
        state[f"decoder.samplers.{i}.conv.weight"] = _conv_weight(
            sampler["conv/kernel"], spatial_rank)
        state[f"decoder.samplers.{i}.conv.bias"] = sampler["conv/bias"]
        if f"out_conv{i}" in groups:  # side outputs
            out = groups.pop(f"out_conv{i}")
            state[f"out_conv.{i}.weight"] = _conv_weight(out["kernel"], spatial_rank)
            state[f"out_conv.{i}.bias"] = out["bias"]
    block("base", "base")
    if "out_conv" in groups:
        out = groups.pop("out_conv")
        state["out_conv.weight"] = _conv_weight(out["kernel"], spatial_rank)
        state["out_conv.bias"] = out["bias"]
    if groups:
        raise ValueError(f"Unmapped parameter groups: {sorted(groups)}")
    result = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()}
    if tracked:  # torch's counter, which the JAX package does not keep
        for key in [k for k in result if k.endswith(".running_mean")]:
            result[key.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(0, dtype=torch.long)
    return result
