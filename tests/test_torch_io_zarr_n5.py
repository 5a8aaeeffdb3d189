"""The port's zarr and N5 I/O, ``squeeze_singleton_dims`` and the numpy MitoLab split against the
JAX package and sklearn.

The JAX package reads and writes zarr and N5 through tensorstore, the port through its own
``utils/zarr_n5.py`` (with the blosc codec of ``ops/native/blosc.cpp``). N5 keeps ``dimensions`` and
``blockSize`` column-major on disk, and both read and write it through the transposed, C-order
view. Volumes are seeded numpy arrays; every comparison is exact.
"""

import json
import struct

import numpy as np
import pytest
from sklearn.model_selection import train_test_split

from torch_em_tpu.utils import io as jax_io
from torch_em_tpu.utils import tensor as jax_tensor
from torch_em_tpu_torch.data import SegmentationDataset
from torch_em_tpu_torch.data.datasets.electron_microscopy import cem
from torch_em_tpu_torch.utils import io, tensor

FORMATS = ("zarr", "n5")
SHAPE = (8, 48, 64)
INDEXES = [np.s_[:], np.s_[2:5], np.s_[1:7, 10:40, 3:61], np.s_[3, :, 5:9], np.s_[..., 0:32], np.s_[7]]


def _volume(seed=0, dtype="uint16"):
    return np.random.default_rng(seed).integers(0, 1000, SHAPE).astype(dtype)


def _metadata(path, key, fmt):
    name = ".zarray" if fmt == "zarr" else "attributes.json"
    return json.loads((path / key / name).read_text())


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_written_volume_reads_the_same(fmt, writer, tmp_path):
    """A volume written by either package reads back equal in both: ``load_data``,
    ``get_dataset_shape``, windows of ``LazyTensorStore`` and of a ``RoiWrapper`` over it."""
    path = str(tmp_path / f"data.{fmt}")
    data = _volume(1)
    (jax_io if writer == "jax" else io).write_data(path, "volumes/raw", data, chunks=(4, 16, 32))
    ours, theirs = io.load_data(path, "volumes/raw"), jax_io.load_data(path, "volumes/raw")
    assert isinstance(ours, io.LazyTensorStore) and ours.ndim == 3 and len(ours) == SHAPE[0]
    assert ours.shape == theirs.shape == SHAPE and ours.dtype == theirs.dtype == data.dtype
    assert io.get_dataset_shape(path, "volumes/raw") == jax_io.get_dataset_shape(path, "volumes/raw") == SHAPE
    for index in INDEXES:
        np.testing.assert_array_equal(ours[index], data[index])
        np.testing.assert_array_equal(ours[index], theirs[index])
    roi = np.s_[1:6, 4:44, 8:60]
    ours_roi, theirs_roi = io.RoiWrapper(ours, roi), jax_io.RoiWrapper(theirs, roi)
    assert ours_roi.shape == theirs_roi.shape == (5, 40, 52)
    for index in (np.s_[:], np.s_[1:3, 5:20], np.s_[2]):
        np.testing.assert_array_equal(ours_roi[index], theirs_roi[index])
        np.testing.assert_array_equal(ours_roi[index], data[roi][index])


@pytest.mark.parametrize("fmt", FORMATS)
def test_chunks_round_trip(fmt, tmp_path):
    """The port writes the JAX package's metadata: zarr chunks as given, N5 ``dimensions`` and
    ``blockSize`` reversed; rewriting a key replaces it."""
    ours, theirs = tmp_path / f"ours.{fmt}", tmp_path / f"theirs.{fmt}"
    for module, path in ((io, ours), (jax_io, theirs)):
        module.write_data(str(path), "raw", _volume(2, "float32"), chunks=(2, 24, 16))
        module.write_data(str(path), "labels", _volume(3, "uint64"))
    for key in ("raw", "labels"):
        assert _metadata(ours, key, fmt) == _metadata(theirs, key, fmt)
    meta = _metadata(ours, "raw", fmt)
    if fmt == "zarr":
        assert meta["shape"] == list(SHAPE) and meta["chunks"] == [2, 24, 16]
    else:
        assert meta["dimensions"] == list(SHAPE)[::-1] and meta["blockSize"] == [16, 24, 2]
    io.write_data(str(ours), "raw", _volume(4, "uint8")[:4])
    replaced = jax_io.load_data(str(ours), "raw")
    assert replaced.shape == (4,) + SHAPE[1:] and replaced.dtype == np.uint8
    np.testing.assert_array_equal(replaced[:], _volume(4, "uint8")[:4])


def test_hand_written_n5_reads_transposed(tmp_path):
    """An N5 dataset written byte by byte: ``attributes.json`` with column-major ``dimensions``
    (x, y, z) and one raw block in N5's big-endian layout. Both packages read it as (z, y, x)."""
    data = _volume(5)
    root = tmp_path / "hand.n5"
    (root / "raw" / "0" / "0").mkdir(parents=True)
    (root / "attributes.json").write_text(json.dumps({"n5": "2.0.0"}))
    dims = list(SHAPE)[::-1]
    (root / "raw" / "attributes.json").write_text(json.dumps(
        {"dimensions": dims, "blockSize": dims, "dataType": "uint16", "compression": {"type": "raw"}}))
    header = struct.pack(">HH", 0, 3) + struct.pack(">III", *dims)
    (root / "raw" / "0" / "0" / "0").write_bytes(header + data.astype(">u2").tobytes())
    ours, theirs = io.load_data(str(root), "raw"), jax_io.load_data(str(root), "raw")
    assert ours.shape == theirs.shape == SHAPE
    np.testing.assert_array_equal(ours[:], data)
    np.testing.assert_array_equal(ours[2:6, 7:9], theirs[2:6, 7:9])


@pytest.mark.parametrize("fmt", FORMATS)
def test_segmentation_dataset_over_a_store(fmt, tmp_path):
    """A ``SegmentationDataset`` reads the port's zarr or N5 volumes lazily; its samples equal
    those of the same arrays in memory under the same seed."""
    path = str(tmp_path / f"data.{fmt}")
    raw, labels = _volume(6, "float32"), _volume(7, "uint32") % 4
    io.write_data(path, "raw", raw)
    io.write_data(path, "labels", labels)
    stored = SegmentationDataset(path, "raw", path, "labels", patch_shape=(4, 32, 32))
    in_memory = SegmentationDataset(raw, None, labels, None, patch_shape=(4, 32, 32))
    for i in range(3):
        np.random.seed(i)
        x, y = stored[i]
        np.random.seed(i)
        xe, ye = in_memory[i]
        np.testing.assert_array_equal(x, xe)
        np.testing.assert_array_equal(y, ye)


@pytest.mark.parametrize("shape,target", [((1, 1, 5, 6), 2), ((1, 5, 6), 2), ((5, 6), 2), ((1, 1, 1, 4), 1),
                                          ((2, 1, 5), 2), ((1, 3, 1, 7), 2), ((1, 4, 5, 6), 3)])
def test_squeeze_singleton_dims_matches_jax(shape, target):
    arr = np.arange(int(np.prod(shape))).reshape(shape)
    got, expected = tensor.squeeze_singleton_dims(arr, target), jax_tensor.squeeze_singleton_dims(arr, target)
    assert got.shape == expected.shape
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("n", [2, 7, 20, 21, 100, 256, 1001])
@pytest.mark.parametrize("test_size", [0.05, 0.2, 0.5])
def test_mitolab_split_matches_sklearn(n, test_size):
    """``cem._train_test_split`` is sklearn's ``train_test_split`` (ShuffleSplit: ceil(test_size
    * n) test items from the front of ``RandomState(42).permutation(n)``), without sklearn."""
    raws = [f"images/p{i}.tiff" for i in range(n)]
    labels = [f"masks/p{i}.tiff" for i in range(n)]
    expected = train_test_split(raws, labels, test_size=test_size, random_state=42)
    got = cem._train_test_split(raws, labels, test_size=test_size, random_state=42)
    assert list(got) == list(expected)
    assert all(type(part) is list for part in got)
