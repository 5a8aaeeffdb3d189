"""The port's instance norm against the JAX package's Pallas kernel and plain path.

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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_em_tpu.models.unet import _norm_core
from torch_em_tpu.ops.pallas.norm import instance_norm_pallas, supports_pallas_norm
from torch_em_tpu_torch.models import AnisotropicUNet, resolve_device
from torch_em_tpu_torch.ops.instance_norm import instance_norm_reference

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
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
