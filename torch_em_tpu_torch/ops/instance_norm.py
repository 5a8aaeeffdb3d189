"""Parameter-free instance norm over the spatial axes: the Hopper kernel and its plain version.

Counterpart of the Pallas forward kernel ``_fwd_kernel`` in
``torch_em_tpu/ops/pallas/norm.py`` (driven by ``_norm_fwd`` and
``instance_norm_pallas``) and of the plain path the JAX package takes where
that kernel's VMEM gate refuses a shape (``_instance_norm``, ``_pc_stats``
and ``_norm_core`` in ``torch_em_tpu/models/unet.py``). Both compute, per
(sample, channel), f32 ``mean`` and ``E[x^2]`` in one pass,
``rstd = rsqrt(E[x^2] - mean^2 + eps)`` with no clamp, and
``(x - mean) * rstd`` in x's dtype.

The kernel (``csrc/instance_norm.cu``) takes every shape: the TPU's gate
(C divides 128, a slab of at most 2 MB) has no counterpart on Hopper, so
one kernel serves C=1 (the raw input) up to C=512 at any spatial size.

Bound: bytes. The function must read x once and write y once,
``2 * numel * itemsize`` bytes; at 3.35 TB/s (H100 SXM) that is 1.01 ms for
the largest main-path norm (64 channels of a 40x576x576 halo block in bf16,
3.40 GB). The kernel reads x twice (a split reduction, then a normalise
pass), so its traffic is 1.5x that bound; see the source for the design.

On a CPU tensor :func:`instance_norm` runs :func:`instance_norm_reference`;
on a CUDA tensor it launches the kernel or raises. ``instance_norm.launches``
counts kernel launches (one per call on a CUDA tensor).
"""

import ctypes
import functools

import torch

from ._build import load_library

__all__ = ["instance_norm", "instance_norm_reference", "load_kernel"]

EPS = 1e-5
# elements of one row that one block of the kernel reduces and normalises;
# a multiple of every vector width (4 f32, 8 bf16)
CHUNK = 16384
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def instance_norm_reference(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Plain PyTorch instance norm of (N, C, *spatial) with the JAX package's math."""
    spatial = tuple(range(2, x.ndim))
    xf = x.float()
    mean = xf.mean(dim=spatial, keepdim=True)
    mean_sq = (xf * xf).mean(dim=spatial, keepdim=True)
    rstd = torch.rsqrt(mean_sq - mean * mean + eps)
    return ((xf - mean) * rstd).to(x.dtype)


@functools.lru_cache(maxsize=None)
def load_kernel():
    """Build (at first use) and bind the kernel's C entry point."""
    fn = load_library("tem_instance_norm", "instance_norm.cu").tem_instance_norm_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, y, partial
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # rows, L, chunk
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # splits, dtype, vec
        ctypes.c_float, ctypes.c_void_p,                     # eps, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _instance_norm_cuda(x: torch.Tensor, eps: float) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"the instance-norm kernel needs a CUDA tensor, got one on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the instance-norm kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim < 3:
        raise ValueError(f"expected (N, C, *spatial), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the instance-norm kernel needs a contiguous (N, C, *spatial) tensor")
    rows = x.shape[0] * x.shape[1]
    length = x[0, 0].numel()
    y = torch.empty_like(x)
    if rows == 0 or length == 0:
        return y
    width = 16 // x.element_size()  # elements in one 16-byte load
    vec = width if length % width == 0 and x.data_ptr() % 16 == 0 else 1
    splits = -(-length // CHUNK)
    if rows * splits >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} needs more blocks than one launch can take")
    partial = torch.empty((rows * splits, 2), dtype=torch.float32, device=x.device)
    fn = load_kernel()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), partial.data_ptr(), rows, length, CHUNK, splits,
                 _DTYPE_CODES[x.dtype], vec, float(eps), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"instance-norm kernel launch failed with CUDA error {err}")
    instance_norm.launches += 1
    return y


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Instance norm of (N, C, *spatial): the CUDA kernel on the card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return instance_norm_reference(x, eps)
    return _instance_norm_cuda(x, eps)


instance_norm.launches = 0
