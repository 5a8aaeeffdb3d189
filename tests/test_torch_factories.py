"""The port's datasets, image reading and loader factories against the JAX package's.

Every dataset draws its bounding boxes from the global ``np.random``, so the
same ``np.random.seed`` before each sample gives both packages the same
patch. With an identity ``transform`` (the default augmentations draw from
their own generators) the factories' datasets and loaders give the same
samples and batches; with ``transform=None`` they pick the same dataset
class, default augmentations and dimensionality.
"""

import os

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

import torch_em_tpu as jax_em
import torch_em_tpu.data as jax_data
from torch_em_tpu.utils import io as jax_io
import torch_em_tpu_torch as port
from torch_em_tpu_torch import data
from torch_em_tpu_torch.transforms import BoundaryTransform
from torch_em_tpu_torch.utils import io, util


def identity(raw, labels):
    return raw, labels


def _same_samples(port_ds, jax_ds, n=None, seed=0):
    assert len(port_ds) == len(jax_ds)
    for i in range(len(port_ds) if n is None else n):
        np.random.seed(seed + i)
        got = port_ds[i]
        np.random.seed(seed + i)
        expected = jax_ds[i]
        got, expected = (got, expected) if isinstance(got, tuple) else ((got,), (expected,))
        for g, e in zip(got, expected):
            assert g.dtype == np.asarray(e).dtype and g.shape == np.asarray(e).shape
            np.testing.assert_array_equal(g, np.asarray(e))


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Image collections in three formats: float32 .npy, 8-bit .png (RGB for raw) and 32-bit
    float .tif, with uint16 instance labels; sizes below and above a 32x32 patch."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    files = {}
    for fmt in ("npy", "png", "tif"):
        raws, labels = [], []
        for i, (h, w) in enumerate([(40, 52), (28, 36), (64, 48)]):
            lab = (rng.random((h, w)) > 0.6).astype(np.uint16) * rng.integers(1, 5)
            if fmt == "npy":
                raw = rng.random((h, w)).astype(np.float32)
                np.save(root / f"raw{i}.npy", raw)
                np.save(root / f"lab{i}.npy", lab)
            elif fmt == "png":
                Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(root / f"raw{i}.png")
                Image.fromarray(lab.astype(np.uint8)).save(root / f"lab{i}.png")
            else:
                Image.fromarray(rng.random((h, w)).astype(np.float32)).save(root / f"raw{i}.tif")
                Image.fromarray(lab.astype(np.int32)).save(root / f"lab{i}.tif")
            raws.append(str(root / f"raw{i}.{fmt}"))
            labels.append(str(root / f"lab{i}.{fmt}"))
        files[fmt] = (raws, labels)
    return root, files


@pytest.mark.parametrize("fmt", ["npy", "png", "tif"])
def test_image_reading_matches_jax(images, fmt):
    _, files = images
    for path in files[fmt][0] + files[fmt][1]:
        got, expected = io.load_image(path), jax_io.load_image(path)
        np.testing.assert_array_equal(got, expected)
        assert got.dtype == expected.dtype
        lazy, jax_lazy = io.load_data(path), jax_io.load_data(path)
        assert lazy.shape == jax_lazy.shape and lazy.dtype == jax_lazy.dtype
        np.testing.assert_array_equal(np.asarray(lazy[3:9]), np.asarray(jax_lazy[3:9]))
        assert io.supports_memmap(path) == jax_io.supports_memmap(path)


def test_multipage_tif_and_image_writes(tmp_path):
    frames = [Image.fromarray(np.full((6, 8), v, dtype=np.uint8)) for v in (1, 2, 3)]
    path = str(tmp_path / "stack.tif")
    frames[0].save(path, save_all=True, append_images=frames[1:])
    np.testing.assert_array_equal(io.load_image(path), jax_io.load_image(path))
    assert io.load_data(path).shape == (3, 6, 8)
    image = np.random.default_rng(1).integers(0, 255, (12, 10), dtype=np.uint8)
    io.write_data(str(tmp_path / "out.png"), None, image)
    np.testing.assert_array_equal(jax_io.load_image(str(tmp_path / "out.png")), image)
    stacked = io.load_data([str(tmp_path / "out.png")] * 2)
    assert stacked.shape == (2, 12, 10)


@pytest.mark.parametrize("path", ["volume.nii.gz", "volume.mha", "volume.nrrd"])
def test_medical_formats_wait_for_medical_io(path, tmp_path):
    with pytest.raises(NotImplementedError, match="medical_io"):
        io.load_data(str(tmp_path / path))


@pytest.mark.parametrize("fmt", ["npy", "png", "tif"])
def test_image_collection_dataset_matches_jax(images, fmt):
    _, files = images
    raws, labels = files[fmt]
    kwargs = dict(patch_shape=(32, 32), label_transform=BoundaryTransform(add_binary_target=True))
    port_ds = data.ImageCollectionDataset(raws, labels, **kwargs)
    jax_ds = jax_data.ImageCollectionDataset(raws, labels, **dict(kwargs, label_transform=(
        jax_em.transforms.BoundaryTransform(add_binary_target=True))))
    _same_samples(port_ds, jax_ds)
    sampled = data.ImageCollectionDataset(raws, labels, patch_shape=(32, 32), n_samples=5,
                                          sampler=data.MinForegroundSampler(0.1))
    jax_sampled = jax_data.ImageCollectionDataset(raws, labels, patch_shape=(32, 32), n_samples=5,
                                                  sampler=jax_data.MinForegroundSampler(0.1))
    _same_samples(sampled, jax_sampled, seed=10)


def test_tensor_dataset_matches_jax():
    rng = np.random.default_rng(2)
    images = [rng.random((2, 30, 40)).astype(np.float32) for _ in range(3)]
    labels = [rng.integers(0, 4, (30, 40)).astype(np.int64) for _ in range(3)]
    kwargs = dict(patch_shape=(24, 24), with_channels=True, n_samples=6)
    _same_samples(data.TensorDataset(images, labels, **kwargs), jax_data.TensorDataset(images, labels, **kwargs))


def test_raw_datasets_match_jax(tmp_path, images):
    volume = np.random.default_rng(3).random((10, 48, 40)).astype(np.float32)
    path = str(tmp_path / "raw.npy")
    np.save(path, volume)
    kwargs = dict(patch_shape=(4, 32, 32), raw_transform=port.standardize, n_samples=4)
    jax_kwargs = dict(kwargs, raw_transform=jax_em.transforms.standardize)
    _same_samples(data.RawDataset(path, None, **kwargs), jax_data.RawDataset(path, None, **jax_kwargs))
    two_views = (port.transforms.normalize, port.standardize)
    jax_views = (jax_em.transforms.normalize, jax_em.transforms.standardize)
    _same_samples(data.RawDataset(path, None, augmentations=two_views, **kwargs),
                  jax_data.RawDataset(path, None, augmentations=jax_views, **jax_kwargs))
    _same_samples(data.RawDatasetWithMasks(path, None, **kwargs),
                  jax_data.RawDatasetWithMasks(path, None, **jax_kwargs))
    raws = images[1]["png"][0]
    _same_samples(data.RawImageCollectionDataset(raws, (24, 24), n_samples=4),
                  jax_data.RawImageCollectionDataset(raws, (24, 24), n_samples=4))


def _volumes(tmp_path, shapes=((16, 64, 64), (16, 64, 64)), fmt="npy"):
    rng = np.random.default_rng(4)
    raws, labels = [], []
    for i, shape in enumerate(shapes):
        raw = rng.random(shape).astype(np.float32)
        lab = (rng.random(shape) > 0.5).astype(np.uint32) * (i + 1)
        if fmt == "npy":
            raws.append(str(tmp_path / f"raw{i}.npy"))
            labels.append(str(tmp_path / f"lab{i}.npy"))
            np.save(raws[-1], raw)
            np.save(labels[-1], lab)
        else:
            path = str(tmp_path / f"vol{i}.h5")
            with h5py.File(path, "w") as f:
                f.create_dataset("raw", data=raw)
                f.create_dataset("labels", data=lab)
            raws.append(path)
            labels.append(path)
    return raws, labels


def test_concat_dataset_and_wrapper_match_jax(tmp_path):
    raws, labels = _volumes(tmp_path, shapes=((8, 40, 40), (12, 48, 48)))
    parts = [data.SegmentationDataset(r, None, lab, None, patch_shape=(4, 32, 32)) for r, lab in zip(raws, labels)]
    jax_parts = [jax_data.SegmentationDataset(r, None, lab, None, patch_shape=(4, 32, 32))
                 for r, lab in zip(raws, labels)]
    concat, jax_concat = data.ConcatDataset(*parts), jax_data.ConcatDataset(*jax_parts)
    assert concat.ds_lens == jax_concat.ds_lens and list(concat.ds_offsets) == list(jax_concat.ds_offsets)
    _same_samples(concat, jax_concat)
    assert len(data.ConcatDataset(datasets=parts)) == len(concat)
    with pytest.raises(ValueError):
        data.ConcatDataset(parts[0], datasets=parts)

    def wrap(sample):
        return sample[0] * 2, sample[1]

    _same_samples(data.DatasetWrapper(concat, wrap), jax_data.DatasetWrapper(jax_concat, wrap), n=3)


def _factory_inputs(kind, tmp_path, images):
    if kind == "npy":
        raws, labels = _volumes(tmp_path)
        return dict(raw_paths=raws, raw_key=None, label_paths=labels, label_key=None, patch_shape=(8, 32, 32))
    if kind == "h5":
        raws, labels = _volumes(tmp_path, shapes=((40, 48, 48),), fmt="h5")
        return dict(raw_paths=raws[0], raw_key="raw", label_paths=labels[0], label_key="labels",
                    patch_shape=(16, 32, 32))
    if kind == "npy_2d":
        raws, labels = images[1]["npy"]
        return dict(raw_paths=raws, raw_key=None, label_paths=labels, label_key=None, patch_shape=(1, 32, 32),
                    ndim=2, is_seg_dataset=False)
    if kind == "folder_glob":
        root = str(images[0])
        return dict(raw_paths=root, raw_key="raw*.tif", label_paths=root, label_key="lab*.tif",
                    patch_shape=(1, 32, 32))
    rng = np.random.default_rng(5)  # in memory
    return dict(raw_paths=[rng.random((40, 40)).astype(np.float32) for _ in range(3)], raw_key=None,
                label_paths=[rng.integers(0, 3, (40, 40)) for _ in range(3)], label_key=None,
                patch_shape=(32, 32))


KINDS = ["npy", "h5", "npy_2d", "folder_glob", "in_memory"]


@pytest.mark.parametrize("kind", KINDS)
def test_factory_dataset_matches_jax(kind, tmp_path, images):
    kwargs = _factory_inputs(kind, tmp_path, images)
    port_ds = port.default_segmentation_dataset(**kwargs)
    jax_ds = jax_em.default_segmentation_dataset(**kwargs)
    assert type(port_ds).__name__ == type(jax_ds).__name__
    inner, jax_inner = port_ds, jax_ds
    if type(port_ds).__name__ == "ConcatDataset":
        inner, jax_inner = port_ds.datasets[0], jax_ds.datasets[0]
    assert type(inner).__name__ == type(jax_inner).__name__
    assert inner.transform.init_kwargs == jax_inner.transform.init_kwargs
    assert inner.transform.factory == "torch_em_tpu_torch.transforms.augmentation.get_augmentations"
    assert type(inner.raw_transform).__name__ == "RawTransform"
    assert inner.raw_transform.normalizer is port.standardize
    assert port_ds.ndim == jax_ds.ndim

    plain = dict(kwargs, transform=identity)
    _same_samples(port.default_segmentation_dataset(**plain), jax_em.default_segmentation_dataset(**plain), n=3)
    loader = port.default_segmentation_loader(batch_size=2, **plain)
    jax_loader = jax_em.default_segmentation_loader(batch_size=2, **plain)
    np.random.seed(7)
    batches = list(loader)
    np.random.seed(7)
    jax_batches = list(jax_loader)
    assert len(batches) == len(jax_batches) == len(loader)
    for batch, jax_batch in zip(batches, jax_batches):
        for got, expected in zip(batch, jax_batch):
            assert isinstance(got, torch.Tensor)
            np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


def test_factory_ndim_heuristic_matches_jax(tmp_path):
    """Flat volumes take the anisotropic flips, others the 3D ones, 2D data the 2D ones."""
    for shape in ((8, 64, 64), (40, 64, 64), (64, 64)):
        raws, labels = _volumes(tmp_path, shapes=(shape,))
        patch = (4, 32, 32) if len(shape) == 3 else (32, 32)
        got = port.default_segmentation_dataset(raws[0], None, labels[0], None, patch_shape=patch)
        expected = jax_em.default_segmentation_dataset(raws[0], None, labels[0], None, patch_shape=patch)
        assert got.transform.init_kwargs == expected.transform.init_kwargs
    assert got.transform.init_kwargs["ndim"] == 2


def test_factory_refuses_inconsistent_paths(tmp_path):
    raws, labels = _volumes(tmp_path)
    with pytest.raises(ValueError):
        port.default_segmentation_dataset(raws, None, labels[:1], None, patch_shape=(8, 32, 32))
    with pytest.raises(ValueError):
        port.default_segmentation_dataset(raws[0], None, labels, None, patch_shape=(8, 32, 32))
    with pytest.raises(ValueError, match="Could not find"):
        port.default_segmentation_dataset([raws[0] + ".missing"], None, labels[:1], None, patch_shape=(8, 32, 32))


def test_n_samples_split_matches_jax(tmp_path):
    raws, labels = _volumes(tmp_path, shapes=((16, 64, 64),) * 3)
    got = port.default_segmentation_dataset(raws, None, labels, None, patch_shape=(8, 32, 32), n_samples=10)
    expected = jax_em.default_segmentation_dataset(raws, None, labels, None, patch_shape=(8, 32, 32), n_samples=10)
    assert got.ds_lens == expected.ds_lens == [4, 3, 3]


def test_trainer_over_factory_loader_survives_from_checkpoint(tmp_path):
    raws, labels = _volumes(tmp_path)
    train = port.default_segmentation_loader(raws, None, labels, None, batch_size=1, patch_shape=(8, 32, 32),
                                             label_transform=BoundaryTransform(), num_workers=2)
    val = port.default_segmentation_loader(raws, None, labels, None, batch_size=1, patch_shape=(8, 32, 32),
                                           label_transform=BoundaryTransform(), n_samples=2)
    model = port.AnisotropicUNet(1, 1, [[1, 2, 2], [2, 2, 2]], initial_features=4, final_activation="Sigmoid",
                                 device="cpu")
    trainer = port.default_segmentation_trainer("factory", model, train, val, device="cpu", save_root=str(tmp_path),
                                                mixed_precision=False)
    trainer.fit(iterations=3)
    resumed = port.DefaultTrainer.from_checkpoint(trainer.checkpoint_folder, "latest", device="cpu")
    ds = resumed.train_loader.dataset
    assert isinstance(ds, data.ConcatDataset) and len(ds.datasets) == 2 and len(ds) == len(train.dataset)
    assert ds.datasets[0].transform.init_kwargs == train.dataset.datasets[0].transform.init_kwargs
    assert isinstance(ds.datasets[0].transform, port.transforms.AugmentationPipeline)
    assert type(ds.datasets[0].raw_transform).__name__ == "RawTransform"
    assert type(ds.datasets[0].label_transform).__name__ == "BoundaryTransform"
    assert resumed.train_loader.num_workers == 2 and resumed.iteration == 3
    resumed.fit(iterations=2)
    assert resumed.iteration == 5
    assert os.path.exists(os.path.join(trainer.checkpoint_folder, "latest.ckpt"))

    folder = trainer.checkpoint_folder
    assert util.get_normalizer(resumed) is port.standardize
    assert util.get_trainer(resumed) is resumed
    loaded = util.load_model(folder, name="latest", device="cpu")
    assert util.model_is_equal(loaded, resumed.model)
    fresh = port.AnisotropicUNet(1, 1, [[1, 2, 2], [2, 2, 2]], initial_features=4, final_activation="Sigmoid",
                                 device="cpu", seed=9)
    assert not util.model_is_equal(fresh, resumed.model)
    assert util.model_is_equal(util.load_model(folder, model=fresh, name="latest"), resumed.model)
    assert util.get_constructor_arguments(train.dataset)["datasets"] == train.dataset.datasets
    assert util.auto_compile(fresh) is fresh and not util.is_compiled(fresh)
