"""HDF5 through the port's own module (``utils/hdf5.py``) against the JAX package (h5py).

On the 12 tracked ``experiments/parity/parity_data*/**/*.h5`` files and on a ``bench.py``-shaped
volume at a small size, written by the port with no filter and with gzip: both packages'
``load_data`` give the same arrays, shapes and dtypes, and both ``SegmentationDataset``s give
the same first patches from the same ``np.random`` seed (each package with its own
``AffinityTransform`` on the bench volume). The comparisons are exact.
"""

import glob
import os

import numpy as np
import pytest

from torch_em_tpu.data.segmentation_dataset import SegmentationDataset as JaxSegmentationDataset
from torch_em_tpu.transforms.label import AffinityTransform as JaxAffinityTransform
from torch_em_tpu.utils import io as jax_io
from torch_em_tpu_torch.data import SegmentationDataset
from torch_em_tpu_torch.transforms.label import AffinityTransform
from torch_em_tpu_torch.utils import hdf5, io

PARITY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments", "parity")
TRACKED = sorted(os.path.relpath(p, PARITY)
                 for p in glob.glob(os.path.join(PARITY, "parity_data*", "**", "*.h5"), recursive=True))
# bench.py's loader volume (64x512x512 in (32, 128, 128) chunks) cut to a CPU's size
BENCH_VOLUME, BENCH_CHUNKS, BENCH_PATCH = (16, 128, 128), (8, 32, 32), (8, 64, 64)


def test_the_tracked_files_are_twelve():
    assert len(TRACKED) == 12


@pytest.mark.parametrize("name", TRACKED)
def test_load_data_matches_jax_on_tracked_files(name):
    path = os.path.join(PARITY, name)
    with hdf5.File(path) as f:
        keys = sorted(f)
    assert {"raw", "labels"} <= set(keys)
    for key in keys:
        ours, theirs = io.load_data(path, key), jax_io.load_data(path, key)
        assert ours.shape == theirs.shape and ours.dtype == theirs.dtype and ours.chunks == theirs.chunks
        np.testing.assert_array_equal(ours[()], theirs[()])
        window = (slice(1, 7), slice(3, None, 5)) + (slice(None),) * (ours.ndim - 2)
        np.testing.assert_array_equal(ours[window], theirs[window])


@pytest.mark.parametrize("name", TRACKED)
def test_segmentation_datasets_match_on_tracked_files(name):
    path = os.path.join(PARITY, name)
    ndim, patch = (3, (8, 64, 64)) if "parity_data3d" in name else (2, (1, 64, 64))
    kwargs = dict(patch_shape=patch, ndim=ndim, n_samples=6)
    jax_ds = JaxSegmentationDataset(path, "raw", path, "labels", **kwargs)
    port_ds = SegmentationDataset(path, "raw", path, "labels", **kwargs)
    _assert_same_samples(jax_ds, port_ds, seed=21)


def _assert_same_samples(jax_ds, port_ds, seed, n=4):
    assert len(port_ds) == len(jax_ds)
    np.random.seed(seed)
    expected = [jax_ds[i] for i in range(n)]
    np.random.seed(seed)
    got = [port_ds[i] for i in range(n)]
    for (xe, ye), (xg, yg) in zip(expected, got):
        assert xg.shape == xe.shape and np.asarray(xg).dtype == np.asarray(xe).dtype
        np.testing.assert_array_equal(np.asarray(xg), np.asarray(xe))
        np.testing.assert_array_equal(np.asarray(yg), np.asarray(ye))


@pytest.mark.parametrize("compression", [None, "gzip"])
def test_bench_volume_matches_jax(tmp_path, compression):
    rng = np.random.default_rng(0)
    raw = rng.random(BENCH_VOLUME, dtype=np.float32)
    labels = rng.integers(1, 500, BENCH_VOLUME).astype("uint32")
    path = str(tmp_path / "vol.h5")
    if compression is None:
        with hdf5.File(path, "w") as f:
            f.create_dataset("raw", data=raw, chunks=BENCH_CHUNKS)
            f.create_dataset("labels", data=labels, chunks=BENCH_CHUNKS)
    else:
        io.write_data(path, "raw", raw, chunks=BENCH_CHUNKS)
        io.write_data(path, "labels", labels, chunks=BENCH_CHUNKS)
    for key, expected in (("raw", raw), ("labels", labels)):
        ours, theirs = io.load_data(path, key), jax_io.load_data(path, key)
        assert ours.shape == theirs.shape == BENCH_VOLUME and ours.dtype == theirs.dtype == expected.dtype
        assert theirs.compression == compression and theirs.chunks == BENCH_CHUNKS
        np.testing.assert_array_equal(theirs[()], expected)
        np.testing.assert_array_equal(ours[3:11, 17:90, 5:70], theirs[3:11, 17:90, 5:70])
    jax_ds = JaxSegmentationDataset(path, "raw", path, "labels", patch_shape=BENCH_PATCH,
                                    label_transform=JaxAffinityTransform(offsets=[[-1, 0, 0]], add_mask=False))
    port_ds = SegmentationDataset(path, "raw", path, "labels", patch_shape=BENCH_PATCH,
                                  label_transform=AffinityTransform(offsets=[[-1, 0, 0]], add_mask=False))
    _assert_same_samples(jax_ds, port_ds, seed=3)
