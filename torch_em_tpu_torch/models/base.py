"""Activations by name, the device an entry point runs on, and a resize.

Counterpart of ``torch_em_tpu/models/base.py`` (``ACTIVATIONS``,
``get_activation``). The activations take channel-first tensors.
``resize_linear`` is ``jax.image.resize`` with the linear kernel, which the
JAX package's transformer models use for their position tables and their
input and output resizes.
"""

from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ACTIVATIONS", "get_activation", "resolve_device", "resize_linear"]


ACTIVATIONS: Dict[str, Callable] = {
    "Sigmoid": torch.sigmoid,
    "Softmax": lambda x: torch.softmax(x, dim=1),
    "Tanh": torch.tanh,
    "ReLU": torch.relu,
    "LeakyReLU": F.leaky_relu,
    # jax.nn.gelu, which the JAX package uses, is the tanh approximation
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "Identity": lambda x: x,
    "ELU": F.elu,
}


def get_activation(activation: Optional[Union[str, Callable]]) -> Optional[Callable]:
    """Resolve an activation given by name (torch-style, e.g. 'Sigmoid') or callable."""
    if activation is None:
        return None
    if callable(activation):
        return activation
    if isinstance(activation, str) and activation in ACTIVATIONS:
        return ACTIVATIONS[activation]
    raise ValueError(f"Invalid activation: {activation}")


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on; a CUDA device must be present when one is asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def _linear_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize``'s linear kernel along one axis: a
    triangle filter at half-pixel sample positions, widened by the shrink factor when the
    axis shrinks (antialiasing), renormalised where it overhangs the border."""
    inv_scale = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / max(inv_scale, 1.0)
    weights = (1.0 - dist).clamp_min(0.0)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_linear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, "linear")``: separable linear interpolation of every axis
    whose size changes, antialiased where it shrinks (``F.interpolate`` antialiases only
    bilinear and bicubic resizes of the last two axes)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"resize_linear: shape {shape} for a tensor of rank {x.ndim}")
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            weights = _linear_weights(n_in, n_out).to(x.device, x.dtype)
            x = torch.matmul(x.movedim(axis, -1), weights).movedim(-1, axis)
    return x
