"""The port's predict_with_halo paths and options against the JAX package's.

The same seeded numpy volume goes through both packages' ``predict_with_halo``
with a small AnisotropicUNet whose JAX parameters are carried into the port.
The host path (numpy input) is compared with the JAX host path, the
device-resident path (a CPU tensor) with the JAX device path (a CPU
``jax.Array``), and every option with the same JAX call. Tolerance: atol 1e-4
on sigmoid outputs (f32 on both sides; convs and norms summed in another
order), as in test_torch_prediction.py.
"""

import functools

import jax.numpy as jnp
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
SHAPE = (8, 36, 40)  # partial edge blocks in y and x
BLOCK, HALO = (4, 16, 16), (2, 4, 4)


@functools.lru_cache(maxsize=None)
def _models(in_channels=1):
    kwargs = dict(in_channels=in_channels, out_channels=2, scale_factors=[[1, 2, 2], [2, 2, 2]],
                  initial_features=4, final_activation="Sigmoid", anisotropic_kernel=True)
    jax_model = JaxAnisotropicUNet(**kwargs, seed=7)
    flat = {k: np.asarray(v) for k, v in flatten_dict(jax_model.variables["params"], sep="/").items()}
    torch_model = AnisotropicUNet(**kwargs, device="cpu")
    torch_model.load_state_dict(state_dict_from_jax_params(flat), strict=True)
    return jax_model, torch_model


def _volume(shape=SHAPE, seed=0, channels=None):
    rng = np.random.default_rng(seed)
    vol = rng.random(((channels,) if channels else ()) + shape, dtype=np.float32)
    vol[..., :16, :] += 1.0  # a bright band, for skip_block
    return vol


def _mask(seed=1):
    mask = np.zeros(SHAPE, dtype=bool)
    mask[:4, :20, 4:24] = np.random.default_rng(seed).random((4, 20, 20)) > 0.3
    return mask


def _centre(p):
    return p - p.mean()


def _halve_jax(model, x):
    return model(x) * 0.5


def _halve_torch(model, x):
    return model(x) * 0.5


def _shift(b):
    return (b - 0.5) * 2.0


def _bright(b):
    return float(b.mean()) > 1.2


# option name -> (the port's kwargs, the JAX package's kwargs); outputs are built per call
OPTIONS = {
    "postprocess": (dict(postprocess=_centre), dict(postprocess=_centre)),
    "postprocess_after_prediction_function": (
        dict(postprocess=_centre, prediction_function=_halve_torch),
        dict(postprocess=_centre, prediction_function=_halve_jax)),
    "prediction_function": (dict(prediction_function=_halve_torch),
                            dict(prediction_function=_halve_jax)),
    "preprocess_on_host": (dict(preprocess=_shift), dict(preprocess=_shift)),
    "preprocess_none": (dict(preprocess=None), dict(preprocess=None)),
    "mask": (dict(mask=_mask()), dict(mask=_mask())),
    "skip_block": (dict(skip_block=_bright), dict(skip_block=_bright)),
    "roi": (dict(roi=(slice(2, 8), slice(5, 30), slice(None))),) * 2,
    "iter_list": (dict(iter_list=[0, 3, 7, 11, 16]),) * 2,
    "grid_shift": (dict(grid_shift=(0.5, 0.25, 0.25)),) * 2,
    "grid_shift_with_mask": (dict(grid_shift=(0.5, 0.5, 0.0), mask=_mask()),) * 2,
    "n_threads": (dict(n_threads=1, batch_size=3), dict(n_threads=1)),
    "output_dtype": (dict(output_dtype="float16"), dict(output_dtype=jnp.float16)),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_matches_jax(option):
    jax_model, torch_model = _models()
    vol = _volume()
    ours, theirs = OPTIONS[option]
    expected = jax_prediction.predict_with_halo(vol, jax_model, block_shape=BLOCK, halo=HALO,
                                                disable_tqdm=True, **theirs)
    got = prediction.predict_with_halo(vol, torch_model, block_shape=BLOCK, halo=HALO,
                                       **dict(dict(batch_size=2), **ours))
    assert isinstance(got, np.ndarray) and got.shape == expected.shape == (2,) + SHAPE
    # float16 outputs: an f32 difference below ATOL may flip one rounding step (2**-11 below 1)
    np.testing.assert_allclose(got, expected, rtol=0, atol=2.0 ** -11 if option == "output_dtype" else ATOL)
    if option in ("mask", "skip_block", "roi", "iter_list"):
        # the blocks left out stay zero on both sides
        assert np.array_equal(got == 0, np.asarray(expected) == 0)


def test_output_array_matches_jax():
    jax_model, torch_model = _models()
    vol = _volume()
    expected, got = np.zeros((2,) + SHAPE, np.float32), np.zeros((2,) + SHAPE, np.float32)
    returned_jax = jax_prediction.predict_with_halo(vol, jax_model, None, BLOCK, HALO, expected,
                                                    disable_tqdm=True)
    returned = prediction.predict_with_halo(vol, torch_model, None, BLOCK, HALO, got)
    assert returned is got and returned_jax is expected
    assert got.any()
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


def test_output_list_matches_jax():
    jax_model, torch_model = _models()
    vol = _volume()

    def outputs():
        return [(np.zeros(SHAPE, np.float32), 0), (np.zeros((1,) + SHAPE, np.float32), slice(1, 2))]

    expected, got = outputs(), outputs()
    jax_prediction.predict_with_halo(vol, jax_model, block_shape=BLOCK, halo=HALO, output=expected,
                                     disable_tqdm=True)
    prediction.predict_with_halo(vol, torch_model, block_shape=BLOCK, halo=HALO, output=got)
    for (g, _), (e, _) in zip(got, expected):
        assert g.any()
        np.testing.assert_allclose(g, e, rtol=0, atol=ATOL)


def test_grid_shift_refuses_an_output():
    _, torch_model = _models()
    with pytest.raises(ValueError, match="grid_shift"):
        prediction.predict_with_halo(_volume(), torch_model, block_shape=BLOCK, halo=HALO,
                                     grid_shift=(0.5, 0, 0), output=np.zeros((2,) + SHAPE, np.float32))


@pytest.mark.parametrize("shape", [(8, 32, 32), SHAPE])
@pytest.mark.parametrize("with_channels", [False, True])
def test_device_resident_path_matches_jax(shape, with_channels):
    """A tensor takes the device-resident path, as a jax.Array takes the JAX one."""
    in_channels = 2 if with_channels else 1
    jax_model, torch_model = _models(in_channels)
    vol = _volume(shape, seed=3, channels=in_channels if with_channels else None)
    kwargs = dict(block_shape=BLOCK, halo=HALO, with_channels=with_channels, batch_size=3)
    expected = jax_prediction.predict_with_halo(jnp.asarray(vol), jax_model, disable_tqdm=True, **kwargs)
    got = prediction.predict_with_halo(torch.from_numpy(vol), torch_model, **kwargs)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == tuple(expected.shape) == (2,) + shape
    assert not got.is_inference() and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=ATOL)
    if shape == (8, 32, 32):  # no partial blocks: the host path agrees
        host = prediction.predict_with_halo(vol, torch_model, **kwargs)
        np.testing.assert_allclose(got.numpy(), host, rtol=0, atol=1e-6)


def test_device_resident_path_options():
    _, torch_model = _models()
    x = torch.from_numpy(_volume((8, 32, 32), seed=4))
    kwargs = dict(block_shape=BLOCK, halo=HALO)
    full = prediction.predict_with_halo(x, torch_model, batch_size=1, **kwargs)
    batched = prediction.predict_with_halo(x, torch_model, batch_size=8, **kwargs)
    torch.testing.assert_close(batched, full, rtol=0, atol=1e-6)
    half = prediction.predict_with_halo(x, torch_model, output_dtype="float16", **kwargs)
    assert half.dtype == torch.float16
    torch.testing.assert_close(half.float(), full, rtol=0, atol=2.0 ** -12)
    raw = prediction.predict_with_halo(x, torch_model, preprocess=None, **kwargs)
    host_raw = prediction.predict_with_halo(x.numpy(), torch_model, preprocess=None, **kwargs)
    np.testing.assert_allclose(raw.numpy(), host_raw, rtol=0, atol=1e-6)


def test_tensor_with_hooks_takes_the_host_path():
    _, torch_model = _models()
    vol = _volume()
    kwargs = dict(block_shape=BLOCK, halo=HALO, postprocess=_centre, mask=_mask())
    got = prediction.predict_with_halo(torch.from_numpy(vol), torch_model, **kwargs)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, prediction.predict_with_halo(vol, torch_model, **kwargs))


def test_tensor_on_another_device_raises():
    _, torch_model = _models()
    with pytest.raises(ValueError, match="move the input there"):
        prediction.predict_with_halo(torch.empty((8, 32, 32), device="meta"), torch_model,
                                     block_shape=BLOCK, halo=HALO)


@pytest.mark.parametrize("pads", [((2, 3), (0, 5), (4, 4)), ((3, 9), (5, 5), (1, 12))])
def test_reflect_pad_matches_numpy_and_jax(pads):
    """Pads as large as the axis (and larger), which F.pad refuses, reflect as numpy does."""
    vol = np.random.default_rng(5).random((2, 4, 6, 5), dtype=np.float32)
    got = prediction._reflect_pad(torch.from_numpy(vol), pads).numpy()
    width = ((0, 0),) + pads
    np.testing.assert_array_equal(got, np.pad(vol, width, mode="reflect"))
    np.testing.assert_array_equal(got, np.asarray(jnp.pad(vol, width, mode="reflect")))


def test_device_standardize_matches_host_standardize():
    x = np.random.default_rng(6).normal(3.0, 2.0, size=(3, 1, 6, 7, 8)).astype(np.float32)
    got = prediction._standardize_batch(torch.from_numpy(x)).numpy()
    for item, g in zip(x, got):
        np.testing.assert_allclose(g, standardize(item), rtol=0, atol=1e-6)
        np.testing.assert_allclose(g, jax_standardize(item), rtol=0, atol=1e-6)


def test_loader_keeps_order_and_lookahead():
    """The load pool yields in block order, never holds more than its lookahead, and
    hands skipped blocks (None) through."""
    import threading

    started, lock = [], threading.Lock()

    def load(i):
        with lock:
            started.append(i)
        return None if i % 3 == 0 else i

    seen = []
    for i, payload in enumerate(prediction._load_ahead(load, range(20), 4, 5)):
        with lock:
            assert len(started) <= i + 1 + 5
        seen.append(payload)
    assert seen == [None if i % 3 == 0 else i for i in range(20)]
