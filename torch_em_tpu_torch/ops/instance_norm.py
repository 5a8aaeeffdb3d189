"""Parameter-free instance norm over the spatial axes: the Hopper kernels and their plain versions.

Counterpart of the Pallas kernels in ``torch_em_tpu/ops/pallas/norm.py``,
the forward ``_fwd_kernel`` (driven by ``_norm_fwd``) and the backward
``_bwd_kernel`` (driven by ``_norm_bwd``, the custom VJP of
``instance_norm_pallas``), and of the plain path the JAX package takes where
the kernels' VMEM gate refuses a shape (``_instance_norm``, ``_pc_stats`` and
``_norm_core`` in ``torch_em_tpu/models/unet.py``). Per (sample, channel):

- forward: f32 ``mean`` and ``E[x^2]`` in one pass,
  ``rstd = rsqrt(E[x^2] - mean^2 + eps)`` with no clamp, ``y = (x - mean) * rstd``
  in x's dtype;
- backward: ``xhat = (x - mean) * rstd``,
  ``dx = rstd * (g - mean(g) - xhat * mean(g * xhat))`` in f32, dx in x's dtype.

The kernels (``csrc/instance_norm.cu``, ``csrc/instance_norm_bwd.cu``) take
every shape: the TPU's gate (C divides 128, a slab of at most 2 MB) has no
counterpart on Hopper, so they serve C=1 (the raw input) up to C=512 at any
spatial size.

Bound: bytes. The forward must read x once and write y once,
``2 * numel * itemsize`` bytes; the backward must read x and g and write dx,
``3 * numel * itemsize``. At 3.35 TB/s (H100 SXM) the forward of the largest
serving norm (64 channels of a 40x576x576 halo block in bf16, 3.40 GB) takes
at least 1.01 ms. Both kernels read their inputs twice (a split reduction,
then an elementwise pass); see the sources for the design.

:func:`instance_norm` is the autograd entry point (:class:`InstanceNormFunction`).
Each direction dispatches on the tensor's device: on a CPU tensor it runs the
plain version, on a CUDA tensor it launches the kernel or raises.
``instance_norm.launches`` counts forward kernel launches and
``instance_norm_backward.launches`` backward ones.
"""

import ctypes
import functools

import torch

from ._build import load_library

__all__ = [
    "InstanceNormFunction", "instance_norm", "instance_norm_forward", "instance_norm_backward",
    "instance_norm_reference", "instance_norm_forward_reference",
    "instance_norm_backward_reference", "load_kernel", "load_backward_kernel",
]

EPS = 1e-5
# elements of one row that one block of a kernel reduces and writes; a
# multiple of every vector width (4 f32, 8 bf16)
CHUNK = 16384
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 for float32 and bfloat16 inputs, as in the kernels; float64 stays float64."""
    return torch.promote_types(x.dtype, torch.float32)


def instance_norm_forward_reference(x: torch.Tensor, eps: float = EPS):
    """Plain PyTorch forward of (N, C, *spatial): ``(y, mean, rstd)``, mean and rstd (N, C)
    in float32 (float64 for a float64 x)."""
    spatial = tuple(range(2, x.ndim))
    xf = x.to(_compute_dtype(x))
    mean = xf.mean(dim=spatial, keepdim=True)
    mean_sq = (xf * xf).mean(dim=spatial, keepdim=True)
    rstd = torch.rsqrt(mean_sq - mean * mean + eps)
    y = ((xf - mean) * rstd).to(x.dtype)
    return y, mean.reshape(x.shape[:2]), rstd.reshape(x.shape[:2])


def instance_norm_reference(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Plain PyTorch instance norm of (N, C, *spatial) with the JAX package's math."""
    return instance_norm_forward_reference(x, eps)[0]


def instance_norm_backward_reference(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                                     rstd: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch backward: dx of the instance norm of x for the output gradient g.

    ``mean`` and ``rstd`` are the forward's (N, C) statistics."""
    spatial = tuple(range(2, x.ndim))
    stat_shape = x.shape[:2] + (1,) * (x.ndim - 2)
    mean, rstd = mean.reshape(stat_shape), rstd.reshape(stat_shape)
    xhat = (x.to(_compute_dtype(x)) - mean) * rstd
    gf = g.to(xhat.dtype)
    mean_g = gf.mean(dim=spatial, keepdim=True)
    mean_gx = (gf * xhat).mean(dim=spatial, keepdim=True)
    return (rstd * (gf - mean_g - xhat * mean_gx)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def load_kernel():
    """Build (at first use) and bind the forward kernel's C entry point."""
    fn = load_library("tem_instance_norm", "instance_norm.cu").tem_instance_norm_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                    # x, y
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # mean, rstd, partial
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # rows, L, chunk
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # splits, dtype, vec
        ctypes.c_float, ctypes.c_void_p,                     # eps, stream
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def load_backward_kernel():
    """Build (at first use) and bind the backward kernel's C entry point."""
    fn = load_library("tem_instance_norm_bwd", "instance_norm_bwd.cu").tem_instance_norm_bwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                    # x, g
        ctypes.c_void_p, ctypes.c_void_p,                    # mean, rstd
        ctypes.c_void_p, ctypes.c_void_p,                    # dx, partial
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # rows, L, chunk
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # splits, dtype, vec
        ctypes.c_void_p,                                     # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_input(x: torch.Tensor, what: str):
    if not x.is_cuda:
        raise ValueError(f"the instance-norm kernel needs a CUDA tensor, got {what} on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the instance-norm kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim < 3:
        raise ValueError(f"expected (N, C, *spatial), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"the instance-norm kernel needs a contiguous (N, C, *spatial) {what}")


def _launch_geometry(x: torch.Tensor, *tensors: torch.Tensor):
    """(rows, L, splits, vec) of a launch over x; 16-byte loads only where every tensor allows."""
    rows = x.shape[0] * x.shape[1]
    length = x[0, 0].numel()
    width = 16 // x.element_size()  # elements in one 16-byte load
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + tensors)
    vec = width if length % width == 0 and aligned else 1
    splits = -(-length // CHUNK)
    if rows * splits >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} needs more blocks than one launch can take")
    return rows, length, splits, vec


def _instance_norm_cuda(x: torch.Tensor, eps: float):
    """Forward kernel: ``(y, mean, rstd)`` of a contiguous CUDA (N, C, *spatial) tensor."""
    _check_input(x, "x")
    y = torch.empty_like(x)
    mean = torch.empty(x.shape[:2], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if x.numel() == 0:
        return y, mean, rstd
    rows, length, splits, vec = _launch_geometry(x, y)
    partial = torch.empty((rows * splits, 2), dtype=torch.float32, device=x.device)
    fn = load_kernel()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), partial.data_ptr(),
                 rows, length, CHUNK, splits, _DTYPE_CODES[x.dtype], vec, float(eps),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"instance-norm kernel launch failed with CUDA error {err}")
    instance_norm.launches += 1
    return y, mean, rstd


def _instance_norm_backward_cuda(x, g, mean, rstd):
    """Backward kernel: dx of a contiguous CUDA (N, C, *spatial) x for the gradient g."""
    _check_input(x, "x")
    _check_input(g, "g")
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} does not match x {tuple(x.shape)} {x.dtype}")
    for stat in (mean, rstd):
        if stat.device != x.device or stat.dtype != torch.float32 or stat.shape != x.shape[:2] \
                or not stat.is_contiguous():
            raise ValueError(f"mean and rstd must be contiguous float32 {tuple(x.shape[:2])} "
                             f"tensors on {x.device}")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    rows, length, splits, vec = _launch_geometry(x, g, dx)
    partial = torch.empty((rows * splits, 2), dtype=torch.float32, device=x.device)
    fn = load_backward_kernel()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                 partial.data_ptr(), rows, length, CHUNK, splits, _DTYPE_CODES[x.dtype], vec,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"instance-norm backward kernel launch failed with CUDA error {err}")
    instance_norm_backward.launches += 1
    return dx


def instance_norm_forward(x: torch.Tensor, eps: float = EPS):
    """``(y, mean, rstd)``: the forward kernel on the card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return instance_norm_forward_reference(x, eps)
    return _instance_norm_cuda(x, eps)


def instance_norm_backward(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                           rstd: torch.Tensor) -> torch.Tensor:
    """dx: the backward kernel on the card, the plain version on the CPU.

    ``g`` comes from autograd and may be a non-contiguous view (an expanded
    or sliced gradient); the kernel needs it contiguous, so it is copied
    here when it is not."""
    if x.device.type == "cpu":
        return instance_norm_backward_reference(x, g, mean, rstd)
    return _instance_norm_backward_cuda(x, g.contiguous(), mean, rstd)


class InstanceNormFunction(torch.autograd.Function):
    """Instance norm with the hand-written backward: saves x, mean and rstd; backward returns dx."""

    @staticmethod
    def forward(ctx, x, eps):
        y, mean, rstd = instance_norm_forward(x, eps)
        ctx.save_for_backward(x, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd = ctx.saved_tensors
        return instance_norm_backward(x, g, mean, rstd), None


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Instance norm of (N, C, *spatial), differentiable: the CUDA kernels on the card,
    the plain versions on the CPU."""
    return InstanceNormFunction.apply(x, eps)


instance_norm.launches = 0
instance_norm_backward.launches = 0
