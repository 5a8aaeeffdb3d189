"""The port's native host ops (``ops/native``) against the JAX package's.

Both packages build their own copy of ``tem_native.cpp``; on the same seeded
inputs the watershed, the mutex watershed (with and without a mask, with
strides on a grid and at random) and the connected components must give
bitwise-equal labels. A failed build raises.
"""

import numpy as np
import pytest
from scipy import ndimage

from test_metrics_decode import make_gt
from torch_em_tpu.ops import host as jax_host
from torch_em_tpu.ops import native as jax_native
from torch_em_tpu_torch.ops import _build, native
from torch_em_tpu_torch.ops.host import compute_affinities

SHAPES = {"2d": (48, 52), "3d": (10, 30, 34)}
OFFSETS = {"2d": [[-1, 0], [0, -1], [-5, 0], [0, -5], [3, 4]],
           "3d": [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [-2, 0, 0], [0, -6, 0], [0, 0, -6], [-1, 3, 3]]}


def _hmap_and_seeds(ndim, seed=0):
    rng = np.random.default_rng(seed)
    shape = SHAPES[ndim]
    hmap = ndimage.gaussian_filter(rng.random(shape, dtype=np.float32), 1.5)
    seeds = np.zeros(shape, dtype=np.uint32)
    n = 12
    seeds[tuple(rng.integers(0, s, n) for s in shape)] = rng.permutation(n) + 1
    mask = ndimage.gaussian_filter(rng.random(shape), 3.0) > 0.49
    return hmap, seeds, mask


def _affinities(ndim, seed=0, noise=0.2):
    """Disaffinities of seeded watershed labels with noise."""
    hmap, seeds, _ = _hmap_and_seeds(ndim, seed)
    labels = jax_native.watershed(hmap, seeds)
    affs, _ = compute_affinities(labels.astype("uint64"), OFFSETS[ndim])
    rng = np.random.default_rng(seed + 1)
    return np.clip(1 - affs + noise * rng.normal(size=affs.shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("ndim", ["2d", "3d"])
@pytest.mark.parametrize("masked", [False, True])
def test_watershed(ndim, masked):
    hmap, seeds, mask = _hmap_and_seeds(ndim)
    mask = mask if masked else None
    got = native.watershed(hmap, seeds, mask=mask)
    expected = jax_native.watershed(hmap, seeds, mask=mask)
    assert got.dtype == expected.dtype == np.uint32
    np.testing.assert_array_equal(got, expected)
    assert len(np.unique(got)) > 5


@pytest.mark.parametrize("ndim", ["2d", "3d"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("strides,randomize", [(None, False), (2, False), (2, True), (3, True)])
def test_mutex_watershed(ndim, masked, strides, randomize):
    affs = _affinities(ndim)
    _, _, mask = _hmap_and_seeds(ndim)
    mask = mask if masked else None
    strides = None if strides is None else [strides] * len(SHAPES[ndim])
    kwargs = dict(strides=strides, randomize_strides=randomize, mask=mask, seed=3)
    got = native.mutex_watershed(affs, OFFSETS[ndim], **kwargs)
    expected = jax_native.mutex_watershed(affs, OFFSETS[ndim], **kwargs)
    np.testing.assert_array_equal(got, expected)
    assert got.dtype == np.uint32 and got.max() > 3
    if masked:
        assert (got[~mask] == 0).all()


@pytest.mark.parametrize("ndim", ["2d", "3d"])
def test_connected_components_labels(ndim):
    hmap, seeds, _ = _hmap_and_seeds(ndim)
    seg = jax_native.watershed(hmap, seeds) % 4  # ids repeat in separate places
    got = native.connected_components_labels(seg)
    np.testing.assert_array_equal(got, jax_native.connected_components_labels(seg))
    assert got.max() > seg.max()


def test_mutex_watershed_recovers_make_gt():
    gt = make_gt()
    offsets = [[-1, 0], [0, -1], [-9, 0], [0, -9]]
    affs, _ = jax_host.compute_affinities(gt.astype("uint64"), offsets)
    seg = native.mutex_watershed((1 - affs).astype(np.float32), offsets)
    np.testing.assert_array_equal(seg, jax_native.mutex_watershed((1 - affs).astype(np.float32), offsets))
    assert len(np.unique(seg)) == len(np.unique(gt))


def test_inputs_are_checked():
    hmap, seeds, mask = _hmap_and_seeds("2d")
    with pytest.raises(ValueError, match="seeds"):
        native.watershed(hmap, seeds[:-1])
    with pytest.raises(ValueError, match="mask"):
        native.watershed(hmap, seeds, mask=mask[:, :-1])
    affs = _affinities("2d")
    with pytest.raises(ValueError, match="offsets"):
        native.mutex_watershed(affs, OFFSETS["2d"][:-1])
    with pytest.raises(ValueError, match="strides"):
        native.mutex_watershed(affs, OFFSETS["2d"], strides=[2])
    with pytest.raises(ValueError, match="axes"):
        native.connected_components_labels(np.zeros((1,) * 9, dtype=np.uint32))


def test_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text('extern "C" void f() { not c++ }\n')
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build broken"):
        _build.compile_library("broken", native._find_gxx, native.GXX_FLAGS, [broken])
    assert not list((tmp_path / "_build").rglob("*.so"))

    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ was not found"):
        _build.compile_library("tem_native", native._find_gxx, native.GXX_FLAGS, [native.SOURCE])
