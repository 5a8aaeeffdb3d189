"""``jax.image.resize``'s cubic and Lanczos resizes, as one weight matrix per resized axis.

The weights are those of ``jax/_src/image/scale.py:compute_weight_mat`` in float32: the kernel
(Keys' cubic with a = -0.5, or Lanczos of radius 3 or 5) at half-pixel sample positions,
widened by the shrink factor where an axis shrinks, each output's weights normalised by their
sum, and zero where the sample lies outside the input. A resize is a product of the tensor with
the matrix of every axis whose size changes, so autograd gives its backward. Shared by the
augmentations' elastic noise (``transforms/augmentation.py:cubic_resize``) and the U-Net's
``Upsampler`` (``models/unet.py``).
"""

import functools
from typing import Sequence

import numpy as np
import torch

__all__ = ["METHODS", "weight_matrix", "resize"]


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype("float32")


def _lanczos(radius: float, x: np.ndarray) -> np.ndarray:
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    out = np.where(x > 1e-3, np.divide(y, np.where(x != 0, np.pi ** 2 * x ** 2, 1)), 1)
    return np.where(x > radius, 0.0, out).astype("float32")


METHODS = {"cubic": _keys_cubic, "lanczos3": functools.partial(_lanczos, 3.0),
           "lanczos5": functools.partial(_lanczos, 5.0)}


@functools.lru_cache(maxsize=128)
def weight_matrix(method: str, input_size: int, output_size: int) -> np.ndarray:
    """(input_size, output_size) float32 weights of ``jax.image.resize(method=...)`` along one
    axis (antialiased, no translation)."""
    inv_scale = 1.0 / (output_size / input_size)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = (np.arange(output_size, dtype="float32") + 0.5) * inv_scale - 0.0 * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(input_size, dtype="float32")[:, None]) / kernel_scale
    weights = METHODS[method](x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype("float32")


@functools.lru_cache(maxsize=128)
def on_device(make, device: torch.device, *args) -> torch.Tensor:
    """``make(*args)`` (a numpy array) as a tensor on ``device``, once per arguments."""
    return torch.from_numpy(make(*args)).to(device)


def along_axis(x: torch.Tensor, axis: int, matrix: torch.Tensor) -> torch.Tensor:
    """Contract axis ``axis`` of ``x`` with the first axis of ``matrix`` (in, out)."""
    return torch.movedim(torch.movedim(x, axis, -1) @ matrix, -1, axis)


def resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for ``method`` in ``METHODS``: every axis whose
    size changes is a product with its weight matrix, in ``x``'s floating type."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match an array of {x.ndim} dimensions")
    if method not in METHODS:
        raise ValueError(f"resize method {method!r} is not one of {sorted(METHODS)}")
    for axis, (m, n) in enumerate(zip(x.shape, shape)):
        if m != n:
            x = along_axis(x, axis, on_device(weight_matrix, x.device, method, m, n).to(x.dtype))
    return x
