"""Carry U-Net weights from the JAX package's flax parameters into the port.

The port keeps its own copy of the mapping in
``torch_em_tpu/utils/modelzoo.py:torch_state_dict_from_flax``: flax block
``encoder<i>`` / ``base`` / ``decoder<i>`` with convs ``conv0`` and ``conv1``
becomes torch-em's ``encoder.blocks.<i>.block.{1,4}`` (``{0,2}`` without a
norm), ``sampler<i>/conv`` becomes ``decoder.samplers.<i>.conv``, and
``out_conv`` stays. Conv kernels go from (*kernel, I, O) to (O, I, *kernel);
the upsamplers' and the output's 1x1 convs are flax ``Dense`` layers with an
(I, O) kernel and become (O, I, 1, ..., 1).
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
) -> Dict[str, torch.Tensor]:
    """Map a flax U-Net ``params`` tree, flattened to ``/``-joined keys, onto the port's state dict.

    ``norm`` is the model's norm: it decides whether the convs of a block
    sit at ``block.{1,4}`` (behind norms) or ``block.{0,2}`` (no norm).
    Only the parameter-free norms (``"InstanceNorm"``, ``None``) are ported.
    """
    if norm not in (None, "InstanceNorm"):
        raise NotImplementedError(f"norm={norm!r} is not ported yet (ROADMAP.md, Queue 1)")
    conv_idx = (0, 2) if norm is None else (1, 4)
    spatial_rank = max(np.ndim(v) for v in flat.values()) - 2
    groups = {}
    for key, value in flat.items():
        top, rest = key.split("/", 1)
        groups.setdefault(top, {})[rest] = value

    state = {}

    def block(src, dst):
        params = groups.pop(src)
        for j in range(2):
            state[f"{dst}.block.{conv_idx[j]}.weight"] = _conv_weight(
                params[f"conv{j}/kernel"], spatial_rank)
            state[f"{dst}.block.{conv_idx[j]}.bias"] = params[f"conv{j}/bias"]

    n_levels = len([k for k in groups if k.startswith("encoder")])
    for i in range(n_levels):
        block(f"encoder{i}", f"encoder.blocks.{i}")
        block(f"decoder{i}", f"decoder.blocks.{i}")
        sampler = groups.pop(f"sampler{i}")
        state[f"decoder.samplers.{i}.conv.weight"] = _conv_weight(
            sampler["conv/kernel"], spatial_rank)
        state[f"decoder.samplers.{i}.conv.bias"] = sampler["conv/bias"]
    block("base", "base")
    if "out_conv" in groups:
        out = groups.pop("out_conv")
        state["out_conv.weight"] = _conv_weight(out["kernel"], spatial_rank)
        state["out_conv.bias"] = out["bias"]
    if groups:
        raise ValueError(f"Unmapped parameter groups: {sorted(groups)}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()}
