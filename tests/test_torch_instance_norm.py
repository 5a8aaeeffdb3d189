"""The port's instance norm against the JAX package's Pallas kernels and plain path.

Inputs come from ``np.random.default_rng(seed)`` and go through both sides
as numpy arrays. The JAX side is channels-last (N, *spatial, C), the port
channel-first (N, C, *spatial).

Tolerances:
- float32: atol 1e-5. Both sides take f32 sums of the same values in another
  order; the outputs are O(1).
- bfloat16: atol 2e-2. Inputs are uniform in [-1, 1), so outputs stay below
  sqrt(3) in magnitude, where one bf16 step is at most 2**-7 ~ 0.0078. The
  Pallas kernel rounds the f32 result once, like the port, so a difference
  is a rounding flip from another summation order; ``_norm_core`` also
  rounds its mean, scale and product to bf16, which adds up to about two
  more steps.

Gradients (dx of the norm for an output gradient g uniform in [-1, 1); dx
stays below about 2.5 in magnitude):
- float32: atol 1e-5, as for the outputs.
- bfloat16 against the Pallas backward and against torch autograd of the
  plain forward: one rounding step of the output, ``2**-7 * |dx| + 1e-5``;
  all three compute in f32 and round dx once.
- bfloat16 against ``_norm_core``'s VJP: four rounding steps at the largest
  |dx|, ``4 * 2**-7 * max|dx|``. It computes in bf16 from the bf16 output
  and bf16 means: the product y * mean(g * y), g - mean(g), their
  difference and the product with the scale each round once more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_em_tpu.models.unet import _norm_core
from torch_em_tpu.ops.pallas.norm import instance_norm_pallas, supports_pallas_norm
from torch_em_tpu_torch.models import AnisotropicUNet, resolve_device
from torch_em_tpu_torch.ops.instance_norm import (
    instance_norm, instance_norm_backward_reference, instance_norm_forward_reference,
    instance_norm_reference,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BF16_STEP = 2.0 ** -7
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _channels_first(a):
    return np.moveaxis(a, -1, 1)


def _inputs(shape_cl, dtype, seed):
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, size=shape_cl).astype(np.float32)
    x_jax = jnp.asarray(x).astype(dtype)
    x_torch = torch.from_numpy(np.ascontiguousarray(_channels_first(x))).to(TORCH_DTYPE[dtype])
    return x_jax, x_torch


def _max_err(y_torch, y_jax):
    ref = _channels_first(np.asarray(y_jax.astype(jnp.float32)))
    return float(np.abs(y_torch.float().numpy() - ref).max())


# channels-last shapes the Pallas gate accepts (C | 128, L*C % 128 == 0, <= 2 MB)
PALLAS_SHAPES = [(2, 8, 16, 16, 32), (1, 4, 8, 8, 64), (2, 16, 16, 8), (1, 2, 8, 8, 128)]
# shapes it refuses, which the JAX package sends to _norm_core: C=1 (the raw
# input), C not dividing 128, C > 128, odd spatial sizes
CORE_SHAPES = [(1, 5, 7, 9, 1), (2, 6, 10, 3), (1, 2, 6, 6, 256), (2, 3, 5, 7, 48)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES)
def test_reference_matches_pallas_kernel(shape, dtype):
    x_jax, x_torch = _inputs(shape, dtype, seed=0)
    assert supports_pallas_norm(x_jax.shape, x_jax.dtype)
    y_jax = instance_norm_pallas(x_jax, interpret=True)
    y = instance_norm_reference(x_torch)
    assert y.dtype == x_torch.dtype and y.shape == x_torch.shape
    assert _max_err(y, y_jax) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CORE_SHAPES)
def test_reference_matches_norm_core(shape, dtype):
    x_jax, x_torch = _inputs(shape, dtype, seed=1)
    assert not supports_pallas_norm(x_jax.shape, x_jax.dtype)
    y_jax = _norm_core(x_jax, 1, None, 1e-5)
    y = instance_norm_reference(x_torch)
    assert _max_err(y, y_jax) <= TOL[dtype]


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AnisotropicUNet(1, 1, [[1, 2, 2]], initial_features=2, device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _grad_inputs(shape_cl, dtype, seed):
    """x and g, channels-last for JAX and channel-first for the port."""
    x_jax, x_torch = _inputs(shape_cl, dtype, seed)
    g_jax, g_torch = _inputs(shape_cl, dtype, seed + 100)
    return x_jax, g_jax, x_torch, g_torch


def _jax_dx(fn, x_jax, g_jax):
    dx = jax.grad(lambda x: jnp.sum(fn(x).astype(jnp.float32) * g_jax.astype(jnp.float32)))(x_jax)
    return _channels_first(np.asarray(dx.astype(jnp.float32)))


def _port_dx(x_torch, g_torch):
    x = x_torch.clone().requires_grad_()
    instance_norm(x).backward(g_torch)
    assert x.grad.dtype == x_torch.dtype
    return x.grad.float().numpy()


def _assert_one_rounding_step(got, ref):
    assert np.all(np.abs(got - ref) <= BF16_STEP * np.abs(ref) + 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES)
def test_gradient_matches_pallas_backward(shape, dtype):
    """The Function's CPU backward against the Pallas _norm_bwd kernel, in interpret mode."""
    x_jax, g_jax, x_torch, g_torch = _grad_inputs(shape, dtype, seed=2)
    assert supports_pallas_norm(x_jax.shape, x_jax.dtype)
    ref = _jax_dx(lambda x: instance_norm_pallas(x, interpret=True), x_jax, g_jax)
    got = _port_dx(x_torch, g_torch)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL[dtype])
    else:
        _assert_one_rounding_step(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CORE_SHAPES)
def test_gradient_matches_norm_core_vjp(shape, dtype):
    x_jax, g_jax, x_torch, g_torch = _grad_inputs(shape, dtype, seed=3)
    ref = _jax_dx(lambda x: _norm_core(x, 1, None, 1e-5), x_jax, g_jax)
    got = _port_dx(x_torch, g_torch)
    atol = TOL[dtype] if dtype == "float32" else 4 * BF16_STEP * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 11), (1, 1, 9, 9), (3, 4, 16)])
def test_backward_reference_matches_autograd(shape, dtype):
    """The plain backward against torch autograd through the plain forward."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(2.0, 0.5, size=shape).astype(np.float32)).to(TORCH_DTYPE[dtype])
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(TORCH_DTYPE[dtype])
    xr = x.clone().requires_grad_()
    instance_norm_reference(xr).backward(g)
    _, mean, rstd = instance_norm_forward_reference(x)
    assert mean.shape == rstd.shape == shape[:2] and mean.dtype == rstd.dtype == torch.float32
    got = instance_norm_backward_reference(x, g, mean, rstd)
    assert got.dtype == x.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), xr.grad.numpy(), rtol=0, atol=TOL[dtype])
    else:
        _assert_one_rounding_step(got.float().numpy(), xr.grad.float().numpy())


def test_forward_reference_statistics():
    x = torch.from_numpy(np.random.default_rng(5).normal(3.0, 2.0, size=(2, 3, 40)).astype(np.float32))
    y, mean, rstd = instance_norm_forward_reference(x)
    assert torch.equal(y, instance_norm_reference(x))
    np.testing.assert_allclose(mean.numpy(), x.numpy().mean(axis=-1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(x.numpy().var(axis=-1) + 1e-5), rtol=1e-5)


def _torch_second_derivative(fn, x0, g, v):
    """d/dx of <dx(x), v>, where dx is the gradient of <fn(x), g>."""
    x = x0.clone().requires_grad_()
    (dx,) = torch.autograd.grad(fn(x), x, g, create_graph=True)
    return torch.autograd.grad(dx, x, v)[0]


def test_second_derivative_matches_reference_and_norm_core():
    """Grad of grad through the Function (create_graph=True) in float64.

    Against autograd of the plain forward: 1e-10 (float64 rounding of O(1)
    values is far below that). Against jax.grad twice of _norm_core under x64:
    _norm_core takes its statistics in float32 for any input type
    (``_pc_stats``), so float32 rounding of mean and rstd sets the difference;
    1e-4 of the largest value, as for a float32 comparison."""
    rng = np.random.default_rng(6)
    shape_cl = (1, 4, 5, 2)
    x_cl, g_cl, v_cl = (rng.normal(size=shape_cl) for _ in range(3))
    x, g, v = (torch.from_numpy(np.ascontiguousarray(_channels_first(a))) for a in (x_cl, g_cl, v_cl))
    got = _torch_second_derivative(instance_norm, x, g, v).numpy()
    ref = _torch_second_derivative(instance_norm_reference, x, g, v).numpy()
    assert np.abs(ref).max() > 0.1  # not trivially zero
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)

    with jax.enable_x64(True):
        xj, gj, vj = jnp.asarray(x_cl), jnp.asarray(g_cl), jnp.asarray(v_cl)
        assert xj.dtype == jnp.float64

        def dx(x):
            return jax.grad(lambda x: jnp.sum(_norm_core(x, 1, None, 1e-5) * gj))(x)

        ddx = jax.grad(lambda x: jnp.sum(dx(x) * vj))(xj)
        ddx = _channels_first(np.asarray(ddx))
    np.testing.assert_allclose(got, ddx, rtol=0, atol=1e-4 * np.abs(ddx).max())
