"""The port's Shallow2Deep against the JAX package's, on the CPU.

The same seeded numpy data go through both packages under the same global
``np.random`` seed, since both draw patches, label balancing, sampling and the
forest of an item from it. Tolerances:

- the filter bank: bitwise (the same scipy calls);
- forests fitted by either package (one thread, a fixed ``random_state``):
  the port's ``.npz`` (fitted by ``fit_forest``, no sklearn) equals
  ``forest_from_sklearn`` of the JAX package's pickle node for node, the
  thresholds bitwise; the port's pickle (``forest_to_sklearn`` of the same
  trees) predicts as the JAX package's, bitwise, on the same features;
- ``Forest.predict_proba`` against sklearn's: atol 1e-12 (float64);
- dataset items and ``RFWithFilters``: atol 1e-6 (the port's numpy forest
  against sklearn's, float32 outputs).

Tiny forests (4 trees) on 32-48 pixel patches keep this under a few seconds.
"""

import importlib
import os
import pickle
import shutil

import numpy as np
import pytest
import torch
from sklearn.ensemble import RandomForestClassifier

from torch_em_tpu.shallow2deep import filters as jax_filters
from torch_em_tpu.shallow2deep import shallow2deep_dataset as jax_dataset
from torch_em_tpu.shallow2deep import shallow2deep_eval as jax_eval
from torch_em_tpu.shallow2deep import shallow2deep_model as jax_model
from torch_em_tpu.shallow2deep import transform as jax_transform
import torch_em_tpu_torch as port
from torch_em_tpu_torch.utils.test import make_mito_image
from torch_em_tpu_torch.shallow2deep import (
    Forest, filters, forest_from_sklearn, load_forest, node_differences, save_forest, shallow2deep_dataset,
    shallow2deep_eval, shallow2deep_model, transform,
)

# the packages export the function prepare_shallow2deep under the module's name
jax_prepare = importlib.import_module("torch_em_tpu.shallow2deep.prepare_shallow2deep")
port_prepare = importlib.import_module("torch_em_tpu_torch.shallow2deep.prepare_shallow2deep")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILTER_CONFIG = [("gaussianSmoothing", 1.6), ("laplacianOfGaussian", 1.6), ("hessianOfGaussianEigenvalues", 1.0)]
DATASET_ATOL, SKLEARN_ATOL = 1e-6, 1e-12
PATCH_MIN, PATCH_MAX = (1, 32, 32), (1, 48, 48)


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    """A seeded (4, 64, 64) raw volume with blob labels, as .npy files."""
    folder = tmp_path_factory.mktemp("s2d")
    rng = np.random.default_rng(0)
    raw = np.stack([make_mito_image(rng, 64)[0] for _ in range(4)])
    labels = (raw < 0.45).astype(np.uint32)
    paths = str(folder / "raw.npy"), str(folder / "labels.npy")
    np.save(paths[0], raw)
    np.save(paths[1], labels)
    return folder, paths


def _prepare(module, out, paths, **kwargs):
    np.random.seed(3)
    module.prepare_shallow2deep(
        paths[0], None, paths[1], None, patch_shape_min=PATCH_MIN, patch_shape_max=PATCH_MAX, n_forests=2,
        n_threads=1, output_folder=str(out), ndim=2,
        label_transform=(jax_transform if module is jax_prepare else transform).ForegroundTransform(ndim=2),
        filter_config=FILTER_CONFIG, n_estimators=4, random_state=0, **kwargs)
    return sorted(str(out / n) for n in os.listdir(out) if n.endswith(".pkl"))


@pytest.fixture(scope="module")
def forests(volume):
    """The pickles of the JAX package's and the port's prepare_shallow2deep, and the port's .npz."""
    folder, paths = volume
    jax_pkl = _prepare(jax_prepare, folder / "jax_rfs", paths)
    port_pkl = _prepare(port_prepare, folder / "port_rfs", paths)
    npz = [p[:-len(".pkl")] + ".npz" for p in port_pkl]
    return jax_pkl, port_pkl, npz


def _features(n=2000, n_features=4, seed=1):
    return np.random.default_rng(seed).normal(0.5, 0.4, (n, n_features)).astype(np.float32)


def _sklearn(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("name", sorted(filters.__all__))
def test_filters_match_jax(name, ndim):
    x = np.random.default_rng(ndim).random((24,) * ndim).astype(np.float32)
    got, expected = getattr(filters, name)(x, 1.6), getattr(jax_filters, name)(x, 1.6)
    assert got.dtype == expected.dtype and np.array_equal(got, expected)


def test_default_filter_bank_matches_jax():
    x = np.random.default_rng(2).random((40, 36)).astype(np.float32)
    got = port_prepare._apply_filters(x, port_prepare._get_filters(2, None))
    expected = jax_prepare._apply_filters(x, jax_prepare._get_filters(2, None))
    assert got.shape == (40 * 36, 28) and np.array_equal(got, expected)
    assert port_prepare._serialize_feature_config(port_prepare._get_filters(2, None)) == \
        jax_prepare._serialize_feature_config(jax_prepare._get_filters(2, None))


@pytest.mark.parametrize("cls", ["ForegroundTransform", "BoundaryTransform"])
def test_rf_targets_match_jax(cls):
    labels = np.zeros((40, 40), dtype=np.uint32)
    labels[5:20, 5:25], labels[22:35, 10:38] = 1, 2
    got, expected = getattr(transform, cls)(ndim=2)(labels), getattr(jax_transform, cls)(ndim=2)(labels)
    assert got.dtype == expected.dtype and np.array_equal(got, expected)


@pytest.mark.parametrize("labels", ["two_classes", "one_class"])
def test_forest_predict_proba_matches_sklearn(labels):
    x = _features()
    y = (x[:, 0] + 0.3 * x[:, 1] > 0.6).astype(int) if labels == "two_classes" else np.zeros(len(x), int)
    rf = RandomForestClassifier(n_estimators=5, random_state=0).fit(x, y)
    forest = forest_from_sklearn(rf)
    test = np.random.default_rng(7).normal(0.5, 0.6, (3000, 4))  # float64, cast to float32 as sklearn does
    got, expected = forest.predict_proba(test), rf.predict_proba(test)
    assert got.shape == expected.shape == (3000, 2 if labels == "two_classes" else 1)
    np.testing.assert_allclose(got, expected, rtol=0, atol=SKLEARN_ATOL)


def test_forest_npz_round_trip(tmp_path):
    x = _features()
    rf = RandomForestClassifier(n_estimators=3, random_state=0).fit(x, (x[:, 2] > 0.5).astype(int))
    rf.feature_ndim, rf.feature_config = 2, [("gaussianSmoothing", 0.7), ("gaussianSmoothing", (1.0, 2.0))]
    save_forest(forest_from_sklearn(rf), str(tmp_path / "rf.npz"))
    forest = load_forest(str(tmp_path / "rf.npz"))
    assert isinstance(forest, Forest) and forest.n_estimators == 3 and forest.n_features_in_ == 4
    assert forest.feature_ndim == 2 and forest.feature_config == rf.feature_config
    assert np.array_equal(forest.predict_proba(x), rf.predict_proba(x))


def test_prepare_shallow2deep_matches_jax(forests, tmp_path):
    jax_pkl, port_pkl, npz = forests
    assert [os.path.basename(p) for p in port_pkl] == [os.path.basename(p) for p in jax_pkl] == \
        ["rf_0000.pkl", "rf_0001.pkl"]
    assert all(os.path.isfile(p) for p in npz)
    x = np.random.default_rng(4).normal(0.5, 0.3, (1500, 4)).astype(np.float32)
    for jp, pp, zp in zip(jax_pkl, port_pkl, npz):
        jax_rf, port_rf = _sklearn(jp), _sklearn(pp)
        assert node_differences(load_forest(zp), forest_from_sklearn(jax_rf)) == []
        assert node_differences(forest_from_sklearn(port_rf), forest_from_sklearn(jax_rf)) == []
        assert type(port_rf) is type(jax_rf) and port_rf.feature_ndim == jax_rf.feature_ndim == 2
        assert port_rf.feature_config == jax_rf.feature_config
        assert np.array_equal(port_rf.predict_proba(x), jax_rf.predict_proba(x))
        np.testing.assert_allclose(load_forest(zp).predict_proba(x), jax_rf.predict_proba(x), rtol=0,
                                   atol=SKLEARN_ATOL)
    # export_forests writes the .npz of a folder of pickles: the same arrays
    for p in port_pkl:
        shutil.copy(p, tmp_path)
    for exported, zp in zip(port_prepare.export_forests(str(tmp_path)), npz):
        assert node_differences(load_forest(exported), load_forest(zp)) == []


@pytest.mark.parametrize("strategy", ["worst_points", "worst_tiles"])
def test_prepare_advanced_matches_jax(volume, strategy, tmp_path):
    _, paths = volume
    kwargs = dict(patch_shape_min=PATCH_MIN, patch_shape_max=PATCH_MAX, n_forests=4, n_threads=1, ndim=2,
                  forests_per_stage=2, sample_fraction_per_stage=0.5, sampling_strategy=strategy,
                  filter_config=FILTER_CONFIG, n_estimators=4, random_state=0)
    np.random.seed(5)
    jax_prepare.prepare_shallow2deep_advanced(paths[0], None, paths[1], None, output_folder=str(tmp_path / "jax"),
                                              label_transform=jax_transform.ForegroundTransform(ndim=2), **kwargs)
    np.random.seed(5)
    port_prepare.prepare_shallow2deep_advanced(paths[0], None, paths[1], None, output_folder=str(tmp_path / "port"),
                                               label_transform=transform.ForegroundTransform(ndim=2), **kwargs)
    x = np.random.default_rng(6).normal(0.5, 0.3, (1000, 4)).astype(np.float32)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 4 and sorted(os.listdir(tmp_path / "port")) == sorted(
        names + [n.replace(".pkl", ".npz") for n in names])
    for name in names:
        jax_rf, port_rf = _sklearn(tmp_path / "jax" / name), _sklearn(tmp_path / "port" / name)
        forest = load_forest(str(tmp_path / "port" / name.replace(".pkl", ".npz")))
        assert node_differences(forest, forest_from_sklearn(jax_rf)) == []
        assert np.array_equal(port_rf.train_labels, jax_rf.train_labels)
        assert np.array_equal(port_rf.train_features, jax_rf.train_features)
        assert np.array_equal(port_rf.predict_proba(x), jax_rf.predict_proba(x))


def _jax_ds(paths, rf_paths, **kwargs):
    return jax_dataset.get_shallow2deep_dataset(paths[0], None, paths[1], None, rf_paths=rf_paths,
                                                patch_shape=(1, 32, 32), ndim=2, n_samples=6,
                                                filter_config=FILTER_CONFIG, **kwargs)


def _port_ds(paths, rf_paths, **kwargs):
    return shallow2deep_dataset.get_shallow2deep_dataset(paths[0], None, paths[1], None, rf_paths=rf_paths,
                                                         patch_shape=(1, 32, 32), ndim=2, n_samples=6,
                                                         filter_config=FILTER_CONFIG, **kwargs)


@pytest.mark.parametrize("fmt", ["pkl", "npz"])
def test_dataset_matches_jax(volume, forests, fmt):
    _, paths = volume
    jax_pkl, _, npz = forests
    port_pkl = [os.path.join(os.path.dirname(npz[0]), os.path.basename(p)) for p in jax_pkl]
    jax_ds = _jax_ds(paths, jax_pkl)
    port_ds = _port_ds(paths, port_pkl if fmt == "pkl" else npz)
    assert isinstance(port_ds, shallow2deep_dataset.Shallow2DeepDataset) and len(port_ds) == len(jax_ds)
    for i in range(len(port_ds)):
        np.random.seed(20 + i)
        xe, ye = jax_ds[i]
        np.random.seed(20 + i)
        xg, yg = port_ds[i]
        assert xg.shape == xe.shape == (1, 32, 32) and xg.dtype == xe.dtype
        np.testing.assert_allclose(xg, xe, rtol=0, atol=DATASET_ATOL)
        np.testing.assert_array_equal(yg, ye)
    assert 0.0 <= xg.min() and xg.max() <= 1.0


def test_one_class_forest_fails_alike(volume, tmp_path):
    """A forest that saw one class has one column: both packages' ``_predict`` stop at the same
    assertion (its IndexError path covers failures inside predict_proba)."""
    _, paths = volume
    x = _features()
    rf = RandomForestClassifier(n_estimators=2, random_state=0).fit(x, np.zeros(len(x), int))
    with open(tmp_path / "rf.pkl", "wb") as f:
        pickle.dump(rf, f)
    save_forest(forest_from_sklearn(rf), str(tmp_path / "rf.npz"))
    for ds in (_jax_ds(paths, [str(tmp_path / "rf.pkl")]), _port_ds(paths, [str(tmp_path / "rf.npz")])):
        np.random.seed(0)
        with pytest.raises(AssertionError, match=r"\(1024, 1\), \(1,\)"):
            ds[0]


def test_dataset_checkpoint_spec_keeps_forests(volume, forests):
    """The forests, filter config and channels are constructor arguments, so a trainer
    checkpoint's spec rebuilds the dataset with them."""
    from torch_em_tpu_torch.trainer.serialization import deserialize_value, serialize_value

    _, paths = volume
    ds = _port_ds(paths, forests[2], rf_channels=1)
    rebuilt = deserialize_value(serialize_value(ds))
    assert rebuilt.rf_paths == list(forests[2]) and rebuilt.rf_channels == (1,)
    assert rebuilt.filter_config == FILTER_CONFIG
    np.random.seed(1)
    a = ds[0]
    np.random.seed(1)
    b = rebuilt[0]
    assert all(np.array_equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("fmt", ["pkl", "npz"])
def test_rf_with_filters_matches_jax(forests, fmt):
    jax_pkl, _, npz = forests
    image = np.random.default_rng(9).random((40, 44)).astype(np.float32)
    expected = jax_model.RFWithFilters(jax_pkl[0], 2, FILTER_CONFIG, output_channel=1)(image)
    got = shallow2deep_model.RFWithFilters(jax_pkl[0] if fmt == "pkl" else npz[0], 2, FILTER_CONFIG,
                                           output_channel=1)(image)
    assert got.shape == expected.shape == (40, 44) and got.dtype == expected.dtype
    np.testing.assert_allclose(got, expected, rtol=0, atol=DATASET_ATOL)
    full = shallow2deep_model.RFWithFilters(npz[0], 2, FILTER_CONFIG)(image)
    np.testing.assert_allclose(full, jax_model.RFWithFilters(jax_pkl[0], 2, FILTER_CONFIG)(image), atol=DATASET_ATOL)


def test_visualize_pretrained_rfs_matches_jax(forests):
    jax_pkl = forests[0]
    image = np.random.default_rng(10).random((32, 32)).astype(np.float32)
    folder = os.path.dirname(jax_pkl[0])
    got = shallow2deep_eval.visualize_pretrained_rfs(folder, image, 2, filter_config=FILTER_CONFIG)
    expected = jax_eval.visualize_pretrained_rfs(folder, image, 2, filter_config=FILTER_CONFIG)
    assert sorted(got) == sorted(expected) == ["rf_0000.pkl", "rf_0001.pkl"]
    for name in got:
        np.testing.assert_allclose(got[name], expected[name], rtol=0, atol=SKLEARN_ATOL)


def test_committed_forests(volume):
    """The forests that the card's run uses load from .npz with the default filter bank's
    config and predict probabilities."""
    folder = os.path.join(REPO, "scripts", "s2d_forests")
    paths = sorted(os.path.join(folder, n) for n in os.listdir(folder))
    assert [os.path.basename(p) for p in paths] == [f"rf_{i:04d}.npz" for i in range(4)]
    assert sum(os.path.getsize(p) for p in paths) < 3e6
    config = port_prepare._serialize_feature_config(port_prepare._get_filters(2, None))
    image = make_mito_image(np.random.default_rng(11), 64)[0]
    for path in paths:
        forest = load_forest(path)
        assert forest.n_estimators == 10 and forest.n_features_in_ == 28 and list(forest.classes_) == [0, 1]
        assert forest.feature_ndim == 2 and forest.feature_config == config
        pred = shallow2deep_model.RFWithFilters(path, 2, forest.feature_config, output_channel=1)(image)
        assert pred.shape == (64, 64) and 0.0 <= pred.min() and pred.max() <= 1.0


def test_enhancer_trains_and_resumes(volume, forests, tmp_path):
    """The enhancer's recipe on the CPU: the loader of forest predictions, a trainer, and a
    resume that rebuilds the Shallow2Deep dataset from the checkpoint."""
    _, paths = volume
    torch.manual_seed(0)

    def loader(n):
        return shallow2deep_dataset.get_shallow2deep_loader(
            paths[0], None, paths[1], None, rf_paths=forests[2], batch_size=2, patch_shape=(1, 32, 32), ndim=2,
            n_samples=n, filter_config=FILTER_CONFIG, num_workers=2)

    model = port.UNet2d(1, 1, depth=2, initial_features=4, final_activation="Sigmoid", device="cpu")
    trainer = port.default_segmentation_trainer("s2d", model, loader(4), loader(2), device="cpu",
                                                mixed_precision=False, save_root=str(tmp_path))
    trainer.fit(iterations=2)
    resumed = port.DefaultTrainer.from_checkpoint(trainer.checkpoint_folder, "latest", device="cpu")
    assert isinstance(resumed.train_loader.dataset, shallow2deep_dataset.Shallow2DeepDataset)
    assert resumed.train_loader.dataset.rf_paths == list(forests[2])
    resumed.fit(iterations=1)
    assert resumed.iteration == 3
