"""The port's data path against the JAX package's.

Both ``SegmentationDataset``s draw their crops (and their samplers' soft
rejections) from the global ``np.random``, so the same ``np.random.seed``
must give the same samples, element for element. Volumes are seeded numpy
arrays; the port also reads them back from ``.npy`` files as memory maps.
The comparisons are exact: nothing here computes in floating point beyond
copying and padding.
"""

import numpy as np
import pytest
import torch

from torch_em_tpu.data.loader import DataLoader as JaxDataLoader
from torch_em_tpu.data.sampler import MinForegroundSampler as JaxMinForegroundSampler
from torch_em_tpu.data.segmentation_dataset import SegmentationDataset as JaxSegmentationDataset
from torch_em_tpu.utils import io as jax_io
from torch_em_tpu.utils import tensor as jax_tensor
from torch_em_tpu_torch.data import DataLoader, MinForegroundSampler, SegmentationDataset
from torch_em_tpu_torch.utils import io, tensor

VOLUME = (12, 40, 48)


def _volumes(seed=0, with_channels=False):
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=((2,) if with_channels else ()) + VOLUME).astype(np.float32)
    labels = rng.integers(0, 3, size=VOLUME).astype(np.uint32)
    return raw, labels


CASES = {
    "3d": dict(patch_shape=(4, 16, 16)),
    "2d_from_3d": dict(patch_shape=(1, 32, 32), ndim=2),
    "padded": dict(patch_shape=(16, 32, 64)),
    "roi": dict(patch_shape=(4, 16, 16), roi=(slice(2, 10), slice(None), slice(8, 40))),
    "z_ext": dict(patch_shape=None, z_ext=5),
    "n_samples": dict(patch_shape=(4, 16, 16), n_samples=7, label_dtype="int64"),
    "channels": dict(patch_shape=(4, 16, 16), with_channels=True),
}


def _datasets(case, raw, labels, port_raw=None, port_labels=None, **extra):
    kwargs = dict(CASES[case], **extra)
    jax_ds = JaxSegmentationDataset(raw, None, labels, None, **kwargs)
    port_ds = SegmentationDataset(raw if port_raw is None else port_raw, None,
                                  labels if port_labels is None else port_labels, None, **kwargs)
    return jax_ds, port_ds


def _assert_same_samples(jax_ds, port_ds, seed, n=6):
    assert len(port_ds) == len(jax_ds)
    np.random.seed(seed)
    expected = [jax_ds[i] for i in range(n)]
    np.random.seed(seed)
    got = [port_ds[i] for i in range(n)]
    for (xe, ye), (xg, yg) in zip(expected, got):
        assert xg.shape == xe.shape and xg.dtype == xe.dtype and yg.dtype == ye.dtype
        np.testing.assert_array_equal(xg, xe)
        np.testing.assert_array_equal(yg, ye)


@pytest.mark.parametrize("case", sorted(CASES))
def test_crops_match_under_same_seed(case):
    raw, labels = _volumes(1, with_channels=CASES[case].get("with_channels", False))
    _assert_same_samples(*_datasets(case, raw, labels), seed=11)


def test_sampler_rejections_match():
    raw, labels = _volumes(2)
    jax_ds = JaxSegmentationDataset(raw, None, labels, None, patch_shape=(4, 16, 16),
                                    sampler=JaxMinForegroundSampler(0.7, p_reject=0.9))
    port_ds = SegmentationDataset(raw, None, labels, None, patch_shape=(4, 16, 16),
                                  sampler=MinForegroundSampler(0.7, p_reject=0.9))
    _assert_same_samples(jax_ds, port_ds, seed=12)


def test_transforms_order_matches():
    raw, labels = _volumes(3)
    kwargs = dict(
        patch_shape=(4, 16, 16), raw_transform=lambda x: x * 2 + 1,
        label_transform=lambda y: (y > 0).astype(np.float32),
        transform=lambda x, y: (x[..., ::-1], y[..., ::-1]),
        label_transform2=lambda y: np.stack([y, 1 - y]),
    )
    jax_ds = JaxSegmentationDataset(raw, None, labels, None, **kwargs)
    port_ds = SegmentationDataset(raw, None, labels, None, **kwargs)
    _assert_same_samples(jax_ds, port_ds, seed=13)


def test_npy_files_are_memory_mapped(tmp_path):
    raw, labels = _volumes(4)
    np.save(tmp_path / "raw.npy", raw)
    np.save(tmp_path / "labels.npy", labels)
    loaded = io.load_data(str(tmp_path / "raw.npy"))
    assert isinstance(loaded, np.memmap) and not loaded.flags.writeable
    jax_ds, port_ds = _datasets("3d", raw, labels, port_raw=str(tmp_path / "raw.npy"),
                                port_labels=str(tmp_path / "labels.npy"))
    _assert_same_samples(jax_ds, port_ds, seed=14)
    assert port_ds.init_kwargs["raw_path"] == str(tmp_path / "raw.npy")


@pytest.mark.parametrize("path", ["data.zarr"])
def test_unported_formats_raise(path, tmp_path):
    with pytest.raises(NotImplementedError, match="not ported"):
        io.load_data(str(tmp_path / path), "raw")


def _h5(tmp_path, raw, labels):
    path = str(tmp_path / "data.h5")
    io.write_data(path, "raw", raw)
    io.write_data(path, "raw_b", raw * 2)
    jax_io.write_data(path, "labels", labels)
    return path


def test_hdf5_reads_match(tmp_path):
    """The port's writes read back through the JAX package, and its writes through the port."""
    raw, labels = _volumes(6)
    path = _h5(tmp_path, raw, labels)
    for key, expected in (("raw", raw), ("labels", labels)):
        ours, theirs = io.load_data(path, key), jax_io.load_data(path, key)
        assert ours.shape == theirs.shape == expected.shape and ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours[2:5, 3:30], theirs[2:5, 3:30])
        np.testing.assert_array_equal(ours[:], expected)
        assert io.get_dataset_shape(path, key) == jax_io.get_dataset_shape(path, key)
    with io.open_container(path) as f:
        assert sorted(f.keys()) == ["labels", "raw", "raw_b"]
    other = str(tmp_path / "other.hdf5")
    io.write_data(other, "raw", raw)
    io.write_data(other, "raw", raw + 1)  # replaces the dataset
    np.testing.assert_array_equal(jax_io.load_data(other, "raw")[:], raw + 1)
    with pytest.raises(ValueError, match="key is required"):
        io.load_data(path)


def test_hdf5_keys_stack_as_channels(tmp_path):
    raw, labels = _volumes(7)
    path = _h5(tmp_path, raw, labels)
    ours, theirs = io.load_data(path, ["raw", "raw_b"]), jax_io.load_data(path, ["raw", "raw_b"])
    assert ours.shape == theirs.shape == (2,) + VOLUME and ours.ndim == 4
    for index in [(slice(None), slice(1, 4)), (1, slice(2, 6), 5), (slice(0, 1), 3), ([1, 0], 2)]:
        np.testing.assert_array_equal(ours[index], theirs[index])


@pytest.mark.parametrize("case", ["3d", "channels"])
def test_segmentation_dataset_reads_hdf5(case, tmp_path):
    raw, labels = _volumes(8, with_channels=case == "channels")
    path = _h5(tmp_path, raw, labels)
    raw_key = ["raw", "raw_b"] if case == "channels" else "raw"
    if case == "channels":
        raw = np.stack([raw[0], raw[0] * 2]) if raw.ndim == 4 else raw
        io.write_data(path, "raw", raw[0])
        io.write_data(path, "raw_b", raw[1])
    kwargs = dict(CASES[case])
    jax_ds = JaxSegmentationDataset(path, raw_key, path, "labels", **kwargs)
    port_ds = SegmentationDataset(path, raw_key, path, "labels", **kwargs)
    _assert_same_samples(jax_ds, port_ds, seed=15)
    assert port_ds.init_kwargs["raw_path"] == path and port_ds.init_kwargs["raw_key"] == raw_key


def test_roi_wrapper_matches():
    raw, _ = _volumes(5)
    roi = (slice(1, 9), slice(4, None), 7)
    expected, got = jax_io.RoiWrapper(raw, roi), io.RoiWrapper(raw, roi)
    assert got.shape == expected.shape and got.ndim == expected.ndim
    for index in [(slice(None),), (2, slice(3, 10)), (slice(1, 4), 5, slice(None))]:
        np.testing.assert_array_equal(got[index], expected[index])


@pytest.mark.parametrize("shape,ndim", [((5, 6), 2), ((1, 5, 6), 2), ((1, 1, 5, 6), 2), ((3, 4, 5, 6), 3)])
def test_tensor_helpers_match(shape, ndim):
    arr = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    np.testing.assert_array_equal(tensor.ensure_array_with_channels(arr, ndim, "float64"),
                                  jax_tensor.ensure_array_with_channels(arr, ndim, "float64"))
    if shape[0] == 1 or len(shape) == ndim:
        np.testing.assert_array_equal(tensor.ensure_spatial_array(arr, ndim),
                                      jax_tensor.ensure_spatial_array(arr, ndim))
    assert tensor.ensure_array(torch.from_numpy(arr)).shape == shape


def test_patch_padding_and_roi_validation_match():
    raw, labels = np.random.default_rng(6).normal(size=(1, 5, 7)), np.ones((5, 7))
    for got, expected in zip(
        tensor.ensure_patch_shape(raw, labels, (4, 8, 9), have_raw_channels=True),
        jax_tensor.ensure_patch_shape(raw, labels, (4, 8, 9), have_raw_channels=True),
    ):
        np.testing.assert_array_equal(got, expected)
    tensor.validate_roi((slice(0, 3), slice(None)), (5, 7))
    for bad in [(slice(0, 9),), (slice(0, 3, 2),), (3,), slice(0, 2)]:
        with pytest.raises(ValueError):
            jax_tensor.validate_roi(bad, (5, 7))
        with pytest.raises(ValueError):
            tensor.validate_roi(bad, (5, 7))


@pytest.mark.parametrize("batch_size,drop_last,shuffle", [(2, False, True), (3, True, True), (4, False, False)])
def test_loader_batches_match(batch_size, drop_last, shuffle):
    raw, labels = _volumes(7)
    jax_ds, port_ds = _datasets("n_samples", raw, labels)
    kwargs = dict(batch_size=batch_size, drop_last=drop_last, shuffle=shuffle, seed=3)
    jax_loader, loader = JaxDataLoader(jax_ds, **kwargs), DataLoader(port_ds, **kwargs)
    assert len(loader) == len(jax_loader)
    for epoch in range(2):
        loader.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        np.random.seed(15 + epoch)
        expected = list(jax_loader)
        np.random.seed(15 + epoch)
        got = list(loader)
        assert len(got) == len(expected) == len(loader)
        for (xe, ye), (xg, yg) in zip(expected, got):
            assert isinstance(xg, torch.Tensor) and isinstance(yg, torch.Tensor)
            np.testing.assert_array_equal(xg.numpy(), xe)
            np.testing.assert_array_equal(yg.numpy(), ye)


def test_threaded_loader_yields_every_batch():
    raw, labels = _volumes(8)
    ds = SegmentationDataset(raw, None, labels, None, patch_shape=(4, 16, 16), n_samples=9)
    loader = DataLoader(ds, batch_size=2, num_workers=3, prefetch_factor=1)
    shapes = [tuple(x.shape) for x, _ in loader]
    assert shapes == [(2, 1, 4, 16, 16)] * 4 + [(1, 1, 4, 16, 16)]
    with pytest.raises(NotImplementedError, match="not ported"):
        DataLoader(ds, worker_mode="process")
