"""The port's U-Net against the JAX package's, with weights carried across.

The JAX model is built with its own seeded init; its flax ``params`` are
flattened to ``/``-joined numpy arrays and loaded into the port through
``state_dict_from_jax_params``. Both run in float32 on the CPU on the same
numpy input. Tolerance: atol 1e-4 on the (sigmoid) outputs, for f32 convs
summed in another order through up to nine conv blocks and 18 norms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from torch_em_tpu.models.base import get_activation as jax_get_activation
from torch_em_tpu.models.unet import POSTPROCESSING as JAX_POSTPROCESSING
from torch_em_tpu.models.unet import AnisotropicUNet as JaxAnisotropicUNet
from torch_em_tpu.models.unet import UNet2d as JaxUNet2d
from torch_em_tpu.models.unet import UNet3d as JaxUNet3d
from torch_em_tpu.utils.modelzoo import torch_state_dict_from_flax
from torch_em_tpu_torch.models import AnisotropicUNet, UNet2d, UNet3d
from torch_em_tpu_torch.models.base import get_activation
from torch_em_tpu_torch.models.unet import POSTPROCESSING
from torch_em_tpu_torch.utils.convert import state_dict_from_jax_params

ATOL = 1e-4
TRACKED_SCALE_FACTORS = [[1, 2, 2], [1, 2, 2], [2, 2, 2], [2, 2, 2]]

# name: (JAX factory, port factory, constructor arguments, seed, input shape)
CONFIGS = {
    "anisotropic_small": (JaxAnisotropicUNet, AnisotropicUNet, dict(
        in_channels=1, out_channels=2, scale_factors=[[1, 2, 2], [2, 2, 2]],
        initial_features=4, final_activation="Sigmoid", anisotropic_kernel=True), 1, (2, 1, 8, 32, 32)),
    # the served configuration at full width (initial_features=32, four levels) on a small input
    "anisotropic_tracked": (JaxAnisotropicUNet, AnisotropicUNet, dict(
        in_channels=1, out_channels=1, scale_factors=TRACKED_SCALE_FACTORS,
        initial_features=32, final_activation="Sigmoid", anisotropic_kernel=True), 0, (1, 1, 16, 64, 64)),
    "unet2d": (JaxUNet2d, UNet2d, dict(
        in_channels=3, out_channels=2, depth=2, initial_features=4), 2, (2, 3, 32, 32)),
    # the DSB recipe's model (experiments/dsb/train_dsb.py) at full width and depth
    "unet2d_dsb": (JaxUNet2d, UNet2d, dict(
        in_channels=1, out_channels=2, initial_features=64, final_activation="Sigmoid"), 6, (1, 1, 64, 64)),
    "unet3d": (JaxUNet3d, UNet3d, dict(
        in_channels=3, out_channels=2, depth=2, initial_features=4), 2, (1, 3, 8, 16, 16)),
}


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    jax_factory, _, kwargs, seed, _ = CONFIGS[name]
    return jax_factory(**kwargs, seed=seed)


def _flat_params(jax_model):
    params = flatten_dict(jax_model.variables["params"], sep="/")
    return {k: np.asarray(v) for k, v in params.items()}


def _compare(jax_model, torch_model, shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    expected = np.asarray(jax.jit(jax_model.module.apply)(jax_model.variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = torch_model(torch.from_numpy(x)).numpy()
    assert got.shape == expected.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_unet_matches_jax(name):
    _, torch_factory, kwargs, _, shape = CONFIGS[name]
    jax_model = _jax_model(name)
    torch_model = torch_factory(**kwargs, device="cpu")
    torch_model.load_state_dict(state_dict_from_jax_params(_flat_params(jax_model)), strict=True)
    _compare(jax_model, torch_model, shape, seed=3)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weight_transposes_match_modelzoo_export(name):
    """The port's copy of the flax -> torch-em mapping against the JAX package's exporter:
    3x3, 3x3x3 and anisotropic 1x3x3 conv kernels, and the Dense 1x1 upsampler and output convs."""
    jax_model = _jax_model(name)
    expected = torch_state_dict_from_flax(jax_model)
    got = state_dict_from_jax_params(_flat_params(jax_model))
    assert sorted(got) == sorted(expected)
    for key, value in expected.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_norm_none_layout_and_forward():
    kwargs = dict(in_channels=1, out_channels=1, depth=2, initial_features=4, norm=None)
    jax_model = JaxUNet2d(**kwargs, seed=4)
    state = state_dict_from_jax_params(_flat_params(jax_model), norm=None)
    assert "encoder.blocks.0.block.0.weight" in state and "encoder.blocks.0.block.2.weight" in state
    torch_model = UNet2d(**kwargs, device="cpu")
    torch_model.load_state_dict(state, strict=True)
    _compare(jax_model, torch_model, (1, 1, 16, 16), seed=5)


@pytest.mark.parametrize("norm", ["GroupNorm", "BatchNorm", "InstanceNormTrackStats"])
def test_unported_norms_raise(norm):
    """These norms raised NotImplementedError until they were ported; now they build, with their
    affine parameters at torch-em's ``block.{0,3}``, and an unknown norm raises. Their parity
    with the JAX package: ``tests/test_torch_norms.py``."""
    state = UNet2d(1, 1, depth=1, initial_features=2, norm=norm, device="cpu").state_dict()
    assert "encoder.blocks.0.block.0.weight" in state and "encoder.blocks.0.block.3.bias" in state
    assert ("encoder.blocks.0.block.0.running_var" in state) == (norm != "GroupNorm")
    with pytest.raises(ValueError, match="Invalid norm"):
        UNet2d(1, 1, depth=1, initial_features=2, norm=norm + "X", device="cpu")


def test_bfloat16_compute_keeps_float32_parameters():
    kwargs = dict(in_channels=1, out_channels=1, scale_factors=[[1, 2, 2]], initial_features=4,
                  final_activation="Sigmoid", device="cpu", seed=3)
    model = AnisotropicUNet(**kwargs, dtype=torch.bfloat16)
    model32 = AnisotropicUNet(**kwargs)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 1, 4, 8, 8)).astype(np.float32))
    with torch.inference_mode():
        y, y32 = model(x), model32(x)
    assert y.dtype == torch.float32 and y.shape == (1, 1, 4, 8, 8)
    # bf16 keeps 8 mantissa bits (~0.4% per rounding) through 4 convs and 4 norms
    np.testing.assert_allclose(y.numpy(), y32.numpy(), rtol=0, atol=5e-2)


def test_seeded_init_is_reproducible():
    a = UNet2d(1, 1, depth=2, initial_features=4, device="cpu", seed=7).state_dict()
    b = UNet2d(1, 1, depth=2, initial_features=4, device="cpu", seed=7).state_dict()
    c = UNet2d(1, 1, depth=2, initial_features=4, device="cpu", seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    # torch's default conv init bound, 1/sqrt(fan_in)
    w = a["encoder.blocks.0.block.1.weight"]
    assert float(w.abs().max()) <= 1 / np.sqrt(w[0].numel())


def test_divisibility_check():
    model = AnisotropicUNet(1, 1, [[1, 2, 2], [2, 2, 2]], initial_features=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        model(torch.zeros(1, 1, 3, 8, 8))


@pytest.mark.parametrize("name", sorted(POSTPROCESSING))
def test_postprocessing_matches_jax(name):
    x = np.random.default_rng(8).uniform(size=(2, 4, 3, 5, 6)).astype(np.float32)
    expected = np.asarray(JAX_POSTPROCESSING[name]()(jnp.asarray(x)))
    np.testing.assert_allclose(POSTPROCESSING[name]()(torch.from_numpy(x)).numpy(), expected,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["Sigmoid", "Softmax", "Tanh", "ReLU", "LeakyReLU", "GELU",
                                  "Identity", "ELU"])
def test_activations_match_jax(name):
    x = np.random.default_rng(9).normal(size=(2, 3, 4, 5)).astype(np.float32) * 3
    expected = np.asarray(jax_get_activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(get_activation(name)(torch.from_numpy(x)).numpy(), expected,
                               rtol=0, atol=1e-5)
