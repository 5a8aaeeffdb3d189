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
every shape, in float32, bfloat16 and float16, with f32 statistics: the
TPU's gate (C divides 128, a slab of at most 2 MB) has no counterpart on
Hopper, so they serve C=1 (the raw input) up to C=512 at any spatial size.
A non-contiguous input (a strided view, ``channels_last_3d``) is copied to
the channel-first layout first.

Bound: bytes. The forward must read x once and write y once,
``2 * numel * itemsize`` bytes; the backward must read x and g and write dx,
``3 * numel * itemsize``. At 3.35 TB/s (H100 SXM) the forward of the largest
serving norm (64 channels of a 40x576x576 halo block in bf16, 3.40 GB) takes
at least 1.01 ms. :func:`plan` picks one of three kernel paths by row length
(``csrc/common.cuh``): the row in registers (A), in a thread-block cluster's
shared memory (B), or re-read from L2 (C); A and B read each input once
from device memory, C reads it once from device memory and once from L2.

:func:`instance_norm` is the entry point: with grad it goes through
:class:`InstanceNormFunction`, without (``torch.no_grad``,
``torch.inference_mode``) it calls the forward alone and keeps no
statistics. Each direction dispatches on the tensor's device: on a CPU
tensor it runs the plain version, on a CUDA tensor it launches the kernel
or raises. ``instance_norm.launches`` counts forward kernel launches and
``instance_norm_backward.launches`` backward ones.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from ._build import load_library

__all__ = [
    "InstanceNormFunction", "Plan", "instance_norm", "instance_norm_forward",
    "instance_norm_backward", "instance_norm_reference", "instance_norm_forward_reference",
    "instance_norm_backward_reference", "load_kernel", "load_backward_kernel", "plan",
]

EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PATH_CODES = {"A": 0, "B": 1, "C": 2}

# The kernels' constants (csrc/common.cuh), which the plan must respect.
THREADS_A, ITEMS_A = 512, 32        # path A: most threads of a block, elements a thread holds
THREADS_B = 1024
THREADS_C, BLOCKS_PER_SM_C = 512, 2
SMEM_B = 225 * 1024                 # path B: most dynamic shared memory of a block
# path C: input bytes of the rows in flight, so that pass 1's reads are still
# in the 50 MB L2 when pass 2 re-reads them (a single larger row is read
# alone); the fastest of 12, 24, 40 and 64 MB on the H100
L2_ROWS_BYTES = 24 * 2 ** 20
H100_SMS = 132


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 for float32 and 16-bit inputs, as in the kernels; float64 stays float64."""
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


class Plan(NamedTuple):
    """How a kernel covers ``rows`` rows of ``length`` elements (``csrc/common.cuh``).

    ``path`` "A" (row in registers), "B" (row in a cluster's shared memory)
    or "C" (row re-read from L2); ``blocks`` of ``threads`` threads;
    ``cluster`` blocks per row (B: the cluster size; C: the row's group);
    ``smem`` dynamic shared memory per block in bytes; ``span`` elements of
    a row per block; ``in_flight`` rows in progress at once."""
    path: str
    blocks: int
    cluster: int
    threads: int
    smem: int
    span: int
    in_flight: int


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=4096)
def plan(rows: int, length: int, itemsize: int, direction: str, sms: int = H100_SMS) -> Plan:
    """The kernel path and launch shape for ``rows`` rows of ``length`` elements of
    ``itemsize`` bytes; ``direction`` is "forward" (reads x) or "backward" (x and g)."""
    inputs = {"forward": 1, "backward": 2}[direction]
    width = 16 // itemsize  # elements of one 16-byte load
    if length <= THREADS_A * ITEMS_A:
        threads = min(THREADS_A, max(128, _ceil_to(-(-length // ITEMS_A), 32)))
        return Plan("A", rows, 1, threads, 0, length, rows)
    for n in (1, 2, 4, 8):
        span = _ceil_to(-(-length // n), width)
        if inputs * span * itemsize <= SMEM_B:
            while n < 8 and rows * n < sms:  # few rows: spread each over more SMs
                n *= 2
            span = _ceil_to(-(-length // n), width)
            return Plan("B", rows * n, n, THREADS_B, inputs * span * itemsize, span, rows)
    grid = sms * BLOCKS_PER_SM_C
    in_flight = max(1, min(rows, L2_ROWS_BYTES // (inputs * length * itemsize)))
    per_row = grid // in_flight
    span = _ceil_to(-(-length // per_row), width)
    return Plan("C", in_flight * per_row, per_row, THREADS_C, 0, span, in_flight)


# rows, L, path, blocks, cluster, threads, smem, span, in_flight, dtype, vec:
# the integer arguments of a launch, read by the kernels' C entries as one
# int64 array (csrc/common.cuh: Launch), built once per shape
_LaunchArgs = ctypes.c_int64 * 11
_ARGS = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=None)
def load_kernel():
    """Build (at first use) and bind the forward kernel's C entry point."""
    fn = load_library("tem_instance_norm", "instance_norm.cu").tem_instance_norm_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                    # x, y
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # mean, rstd, scratch
        _ARGS, ctypes.c_float, ctypes.c_void_p,              # launch arguments, eps, stream
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
        ctypes.c_void_p, ctypes.c_void_p,                    # dx, scratch
        _ARGS, ctypes.c_void_p,                              # launch arguments, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_input(x: torch.Tensor, what: str):
    if not x.is_cuda:
        raise ValueError(f"the instance-norm kernel needs a CUDA tensor, got {what} on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the instance-norm kernel takes float32, bfloat16 or float16, got {x.dtype}")
    if x.ndim < 3:
        raise ValueError(f"expected (N, C, *spatial), got shape {tuple(x.shape)}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _launch_args(shape: torch.Size, dtype: torch.dtype, aligned: bool, index: int, direction: str):
    """(plan, rows, the kernel's integer arguments) of a launch over a contiguous
    tensor; 16-byte loads only where every tensor is aligned. Cached per shape: at
    the deep levels the host's work per call sets the time."""
    rows = shape[0] * shape[1]
    length = 1
    for s in shape[2:]:
        length *= s
    itemsize = torch.empty((), dtype=dtype).element_size()
    width = 16 // itemsize  # elements in one 16-byte load
    vec = width if length % width == 0 and aligned else 1
    p = plan(rows, length, itemsize, direction, _sm_count(index))
    if p.blocks >= 2 ** 31:
        raise ValueError(f"shape {tuple(shape)} needs more blocks than one launch can take")
    return p, rows, _LaunchArgs(rows, length, _PATH_CODES[p.path], *p[1:], _DTYPE_CODES[dtype], vec)


def _scratch(p: Plan, rows: int, device) -> torch.Tensor:
    """Path C's zeroed partial sums (rows x cluster float2) and arrival counters (rows ints)."""
    if p.path != "C":
        return None
    return torch.zeros(rows * (2 * p.cluster + 1), dtype=torch.float32, device=device)


def _stream(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


# the raw handle without a Stream object, where this build of torch has it
_stream = getattr(torch._C, "_cuda_getCurrentRawStream", _stream)


def _launch(fn, device: torch.device, *args) -> int:
    """Call a kernel's C entry on ``device``'s current stream; returns its CUDA error."""
    if device.index == torch.cuda.current_device():
        return fn(*args, _stream(device.index))
    with torch.cuda.device(device):
        return fn(*args, _stream(device.index))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _instance_norm_cuda(x: torch.Tensor, eps: float, stats: bool = True):
    """Forward kernel: ``(y, mean, rstd)`` of a CUDA (N, C, *spatial) tensor; mean and rstd
    are None when ``stats`` is false (inference keeps no statistics)."""
    _check_input(x, "x")
    x = x.contiguous()
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean, rstd = torch.empty((2,) + x.shape[:2], dtype=torch.float32, device=x.device).unbind()
    if x.numel() == 0:
        return y, mean, rstd
    p, rows, args = _launch_args(x.shape, x.dtype, x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0,
                                 x.device.index, "forward")
    scratch = _scratch(p, rows, x.device)
    err = _launch(load_kernel(), x.device, x.data_ptr(), y.data_ptr(), _ptr(mean), _ptr(rstd),
                  _ptr(scratch), args, float(eps))
    if err != 0:
        raise RuntimeError(f"instance-norm kernel launch failed with CUDA error {err} ({p})")
    instance_norm.launches += 1
    return y, mean, rstd


def _instance_norm_backward_cuda(x, g, mean, rstd):
    """Backward kernel: dx of a CUDA (N, C, *spatial) x for the gradient g."""
    _check_input(x, "x")
    _check_input(g, "g")
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} does not match x {tuple(x.shape)} {x.dtype}")
    for stat in (mean, rstd):
        if stat.device != x.device or stat.dtype != torch.float32 or stat.shape != x.shape[:2] \
                or not stat.is_contiguous():
            raise ValueError(f"mean and rstd must be contiguous float32 {tuple(x.shape[:2])} "
                             f"tensors on {x.device}")
    x, g = x.contiguous(), g.contiguous()
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    aligned = x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0 and dx.data_ptr() % 16 == 0
    p, rows, args = _launch_args(x.shape, x.dtype, aligned, x.device.index, "backward")
    scratch = _scratch(p, rows, x.device)
    err = _launch(load_backward_kernel(), x.device, x.data_ptr(), g.data_ptr(), mean.data_ptr(),
                  rstd.data_ptr(), dx.data_ptr(), _ptr(scratch), args)
    if err != 0:
        raise RuntimeError(f"instance-norm backward kernel launch failed with CUDA error {err} ({p})")
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

    ``x`` and ``g`` may be in any layout (autograd hands over expanded or
    sliced gradients); the kernel wrapper copies them to the channel-first
    layout when they are not."""
    if x.device.type == "cpu":
        return instance_norm_backward_reference(x, g, mean, rstd)
    return _instance_norm_backward_cuda(x, g, mean, rstd)


class InstanceNormFunction(torch.autograd.Function):
    """Instance norm with the hand-written backward: saves x, mean and rstd; backward returns dx.

    A backward that itself builds a graph (``create_graph=True``, for a second
    derivative) computes dx with the plain ops instead, the statistics
    recomputed from x, so that autograd can differentiate dx; a first-order
    backward launches the backward kernel on the card."""

    @staticmethod
    def forward(ctx, x, eps):
        y, mean, rstd = instance_norm_forward(x, eps)
        ctx.eps = eps
        ctx.save_for_backward(x, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd = ctx.saved_tensors
        if torch.is_grad_enabled():
            _, mean, rstd = instance_norm_forward_reference(x, ctx.eps)
            return instance_norm_backward_reference(x, g, mean, rstd), None
        return instance_norm_backward(x, g, mean, rstd), None


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Instance norm of (N, C, *spatial), differentiable: the CUDA kernels on the card,
    the plain versions on the CPU. Without grad it runs the forward alone."""
    if torch.is_grad_enabled() and x.requires_grad:
        return InstanceNormFunction.apply(x, eps)
    if x.device.type == "cpu":
        return instance_norm_reference(x, eps)
    return _instance_norm_cuda(x, eps, stats=False)[0]


instance_norm.launches = 0
instance_norm_backward.launches = 0
