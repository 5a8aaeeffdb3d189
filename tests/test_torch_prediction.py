"""The port's tiled prediction against the JAX package's, with the same weights.

Volumes come from ``np.random.default_rng(seed)``; a small AnisotropicUNet is
built by the JAX package and its parameters are carried into the port.
Tolerance: atol 1e-4 on sigmoid outputs, as in test_torch_unet.py (f32 on
both sides; convs and norms summed in another order).
"""

import functools

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from torch_em_tpu.models.unet import AnisotropicUNet as JaxAnisotropicUNet
from torch_em_tpu.transforms.raw import standardize as jax_standardize
from torch_em_tpu.utils import prediction as jax_prediction
from torch_em_tpu_torch.models import AnisotropicUNet
from torch_em_tpu_torch.transforms.raw import standardize
from torch_em_tpu_torch.utils import prediction
from torch_em_tpu_torch.utils.convert import state_dict_from_jax_params

ATOL = 1e-4
SCALE_FACTORS = [[1, 2, 2], [2, 2, 2]]


@functools.lru_cache(maxsize=None)
def _models(in_channels):
    kwargs = dict(in_channels=in_channels, out_channels=2, scale_factors=SCALE_FACTORS,
                  initial_features=4, final_activation="Sigmoid", anisotropic_kernel=True)
    jax_model = JaxAnisotropicUNet(**kwargs, seed=5)
    flat = {k: np.asarray(v) for k, v in flatten_dict(jax_model.variables["params"], sep="/").items()}
    torch_model = AnisotropicUNet(**kwargs, device="cpu")
    torch_model.load_state_dict(state_dict_from_jax_params(flat), strict=True)
    return jax_model, torch_model


@pytest.mark.parametrize("shape,block_shape", [
    ((16, 64, 64), (8, 32, 32)),
    ((17, 60, 70), (8, 32, 32)),
    ((5, 9), (2, 4)),
])
def test_blocking_matches_jax(shape, block_shape):
    ours = prediction.Blocking([0] * len(shape), shape, block_shape)
    theirs = jax_prediction.Blocking([0] * len(shape), shape, block_shape)
    assert ours.n_blocks == theirs.n_blocks and ours.blocks_per_axis == theirs.blocks_per_axis
    for i in range(ours.n_blocks):
        assert ours.get_block(i) == theirs.get_block(i)


@pytest.mark.parametrize("with_channels", [False, True])
@pytest.mark.parametrize("offset", [(0, 0, 0), (8, 32, 32), (16, 32, 64)])
def test_load_block_matches_jax(offset, with_channels):
    rng = np.random.default_rng(0)
    vol = rng.normal(size=((2,) if with_channels else ()) + (17, 60, 70)).astype(np.float32)
    ours, bb = prediction._load_block(vol, offset, (8, 32, 32), (2, 8, 8), with_channels=with_channels)
    theirs, bb_jax = jax_prediction._load_block(vol, offset, (8, 32, 32), (2, 8, 8),
                                                with_channels=with_channels)
    assert bb == bb_jax
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("axis", [None, (1, 2)])
def test_standardize_matches_jax(axis):
    x = np.random.default_rng(1).normal(3.0, 2.0, size=(2, 6, 7)).astype(np.float32)
    np.testing.assert_allclose(standardize(x, axis=axis), jax_standardize(x, axis=axis),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(16, 64, 64), (13, 50, 70)])
@pytest.mark.parametrize("with_channels", [False, True])
def test_predict_with_halo_matches_jax(with_channels, shape):
    in_channels = 2 if with_channels else 1
    jax_model, torch_model = _models(in_channels)
    full = ((in_channels,) if with_channels else ()) + shape
    vol = np.random.default_rng(2).random(full, dtype=np.float32)
    kwargs = dict(block_shape=(8, 32, 32), halo=(2, 8, 8), with_channels=with_channels)
    expected = jax_prediction.predict_with_halo(vol, jax_model, disable_tqdm=True, **kwargs)
    got = prediction.predict_with_halo(vol, torch_model, batch_size=3, **kwargs)
    assert got.shape == expected.shape == (2,) + shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


def test_predict_with_halo_output_dtype_and_batching():
    _, torch_model = _models(1)
    vol = np.random.default_rng(3).random((16, 64, 64), dtype=np.float32)
    kwargs = dict(block_shape=(8, 32, 32), halo=(2, 8, 8))
    single = prediction.predict_with_halo(vol, torch_model, batch_size=1, **kwargs)
    batched = prediction.predict_with_halo(vol, torch_model, batch_size=8, **kwargs)
    half = prediction.predict_with_halo(vol, torch_model, output_dtype="float16", **kwargs)
    np.testing.assert_allclose(batched, single, rtol=0, atol=1e-6)
    # float16 rounding of values in [0, 1]: half a step below 1 is 2**-12
    np.testing.assert_allclose(half, single, rtol=0, atol=2.0 ** -12)
    assert np.array_equal(half, half.astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("shape,block_shape", [
    ((16, 64, 64), (8, 32, 32)),
    ((17, 60, 70), (8, 32, 32)),
    ((5, 9), (2, 4)),
])
def test_blocking_nifty_names_match_jax(shape, block_shape):
    ours = prediction.Blocking([0] * len(shape), shape, block_shape)
    theirs = jax_prediction.Blocking([0] * len(shape), shape, block_shape)
    assert ours.numberOfBlocks == theirs.numberOfBlocks == ours.n_blocks
    for i in range(ours.numberOfBlocks):
        a, b = ours.getBlock(i), theirs.getBlock(i)
        assert (a.begin, a.end, a.shape) == (b.begin, b.end, b.shape)


@pytest.mark.parametrize("with_channels", [False, True])
def test_predict_with_padding_takes_the_reference_argument_order(with_channels):
    """(model, input_, min_divisible, device, with_channels, prediction_function), positionally."""
    in_channels = 2 if with_channels else 1
    jax_model, torch_model = _models(in_channels)
    vol = np.random.default_rng(7).random(((2,) if with_channels else ()) + (15, 30, 30),
                                          dtype=np.float32)
    expected = jax_prediction.predict_with_padding(jax_model, vol, (2, 4, 4), "cpu", with_channels,
                                                   lambda m, x: m(x) * 0.5)
    got = prediction.predict_with_padding(torch_model, vol, (2, 4, 4), "cpu", with_channels,
                                          lambda m, x: m(x) * 0.5)
    assert got.shape == np.asarray(expected).shape == (1, 2, 15, 30, 30)
    np.testing.assert_allclose(got, np.asarray(expected), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="model lies on cpu"):
        prediction.predict_with_padding(torch_model, vol, (2, 4, 4), "cuda", with_channels)


def test_predict_with_padding_matches_jax():
    jax_model, torch_model = _models(1)
    vol = np.random.default_rng(4).random((15, 30, 30), dtype=np.float32)
    expected = jax_prediction.predict_with_padding(jax_model, vol, (2, 4, 4))
    got = prediction.predict_with_padding(torch_model, vol, (2, 4, 4))
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, np.asarray(expected), rtol=0, atol=ATOL)


def test_predict_with_halo_checks_arguments():
    _, torch_model = _models(1)
    with pytest.raises(ValueError, match="entries"):
        prediction.predict_with_halo(np.zeros((8, 32, 32), np.float32), torch_model,
                                     block_shape=(8, 32), halo=(2, 8, 8))


def test_predict_with_halo_takes_the_reference_argument_order():
    """A positional call in the JAX package's (and torch-em's) order:
    (input_, model, gpu_ids, block_shape, halo, output, preprocess, postprocess,
    with_channels)."""
    jax_model, torch_model = _models(1)
    vol = np.random.default_rng(5).random((13, 50, 70), dtype=np.float32)
    args = (None, (8, 32, 32), (2, 8, 8), None, standardize, None, False)
    expected = jax_prediction.predict_with_halo(vol, jax_model, *args[:4], jax_standardize,
                                                *args[5:], disable_tqdm=True)
    got = prediction.predict_with_halo(vol, torch_model, *args)
    assert got.shape == expected.shape == (2, 13, 50, 70)
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)
    on_cpu = prediction.predict_with_halo(vol, torch_model, ["cpu"], (8, 32, 32), (2, 8, 8))
    np.testing.assert_array_equal(on_cpu, got)


@pytest.mark.parametrize("option", ["devices"])
def test_predict_with_halo_refuses_unported_options(option):
    """Several devices, the last option to be ported, take a replica each: on the CPU twice,
    the same prediction as one device."""
    _, torch_model = _models(1)
    vol = np.random.default_rng(6).random((8, 32, 32), dtype=np.float32)
    one = prediction.predict_with_halo(vol, torch_model, block_shape=(8, 32, 32), halo=(2, 8, 8),
                                       **{option: [torch.device("cpu")]})
    np.testing.assert_array_equal(one, prediction.predict_with_halo(vol, torch_model, block_shape=(8, 32, 32),
                                                                    halo=(2, 8, 8)))
    two = prediction.predict_with_halo(vol, torch_model, block_shape=(4, 16, 16), halo=(2, 8, 8),
                                       **{option: ["cpu", "cpu"]})
    np.testing.assert_array_equal(two, prediction.predict_with_halo(vol, torch_model, block_shape=(4, 16, 16),
                                                                    halo=(2, 8, 8)))


def test_predict_with_halo_checks_gpu_ids():
    _, torch_model = _models(1)
    vol = np.zeros((8, 32, 32), np.float32)
    with pytest.raises(ValueError, match="model lies on cpu"):
        prediction.predict_with_halo(vol, torch_model, [0], (8, 32, 32), (2, 8, 8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prediction.predict_with_halo(vol, torch_model, ["cpu", 0], (8, 32, 32), (2, 8, 8))
