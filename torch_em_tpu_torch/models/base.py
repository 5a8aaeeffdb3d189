"""Activations by name, the device an entry point runs on, and a resize.

Counterpart of ``torch_em_tpu/models/base.py`` (``ACTIVATIONS``,
``get_activation``). The activations take channel-first tensors.
``resize_linear`` and ``resize_cubic`` are ``jax.image.resize`` with the
linear and the cubic kernel, which the JAX package's transformer models use
for their position tables and their input and output resizes. The cubic one
is Keys' kernel with a = -0.5 at half-pixel centres, widened and
renormalised where an axis shrinks; ``F.interpolate(mode="bicubic")`` is
a = -0.75 without the widening, another function.
"""

from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ACTIVATIONS", "get_activation", "resolve_device", "resize_linear", "resize_cubic"]


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


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x).clamp_min(0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in: int, n_out: int, kernel: Callable) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize`` along one axis: ``kernel`` at half-pixel
    sample positions, widened by the shrink factor when the axis shrinks (antialiasing),
    renormalised where it overhangs the border."""
    inv_scale = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / max(inv_scale, 1.0)
    weights = kernel(dist)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def _resize(x: torch.Tensor, shape: Sequence[int], kernel: Callable, name: str) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"{name}: shape {shape} for a tensor of rank {x.ndim}")
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            weights = _resize_weights(n_in, n_out, kernel).to(x.device, x.dtype)
            x = torch.matmul(x.movedim(axis, -1), weights).movedim(-1, axis)
    return x


def resize_linear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, "linear")``: separable linear interpolation of every axis
    whose size changes, antialiased where it shrinks (``F.interpolate`` antialiases only
    bilinear and bicubic resizes of the last two axes)."""
    return _resize(x, shape, _triangle, "resize_linear")


def resize_cubic(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, "cubic")``: separable Keys cubic (a = -0.5) interpolation
    of every axis whose size changes, antialiased where it shrinks."""
    return _resize(x, shape, _keys_cubic, "resize_cubic")
