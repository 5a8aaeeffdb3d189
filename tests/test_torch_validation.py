"""Training with a host metric, checkpoint validation and the test-data fixtures of the port.

- ``DefaultTrainer.fit`` on the CPU with ``MWSVOIMetric`` as its validation
  metric: the trainer hands the metric the validation prediction on the host,
  and the metric it records equals the JAX package's ``MWSVOIMetric`` on the
  same prediction and target to 1e-12.
- ``validate_checkpoint(gpu_ids=("cpu",))`` on that checkpoint: the same
  predictions as ``predict_with_halo`` of the rebuilt model, the metric on
  each, predictions written with ``save_path``; the CLI; napari only when
  ``visualize`` asks for it.
- ``utils/test.py``: under the same numpy seed the port's fixtures give the
  same arrays and files as the JAX package's.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

import torch_em_tpu_torch as port
from torch_em_tpu_torch.loss import DiceLoss
from torch_em_tpu_torch.metric import MWSVOIMetric, variation_of_information
from torch_em_tpu_torch.transforms import AffinityTransform
from torch_em_tpu_torch.utils import test as port_test
from torch_em_tpu_torch.utils import validation
from torch_em_tpu_torch.utils.segmentation import mutex_watershed_segmentation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFSETS = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [-2, 0, 0], [0, -4, 0], [0, 0, -4]]
PATCH = (8, 32, 32)


class AffinitiesAndLabels:
    """Disaffinity targets with the instance labels as the last channel, as the
    instance metrics expect them."""

    def __init__(self, offsets):
        self.offsets = offsets
        self.init_kwargs = {"offsets": offsets}

    def __call__(self, labels):
        affs = AffinityTransform(self.offsets)(labels)
        return np.concatenate([affs, labels[None].astype(affs.dtype)])


def dice_on_affinities(pred, target):
    return DiceLoss()(pred, target[:, :-1])


def mws_voi(gt, prediction):
    """VOI of the MWS decode of a prediction against the labels, as validate_checkpoint's metric."""
    seg = mutex_watershed_segmentation(np.ones(prediction.shape[1:], dtype="float32"), prediction, OFFSETS,
                                       min_size=5)
    split, merge = variation_of_information(seg, gt)
    return split + merge


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel workers; torch's thread pool in each would oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class MetricLog:
    def __init__(self, trainer, save_root, **kwargs):
        self.metrics, self.losses = [], []

    def log_train(self, step, loss, lr, x, y, prediction, log_gradients=False):
        self.losses.append(loss)

    def log_validation(self, step, metric, loss, x, y, prediction):
        self.metrics.append((metric, x, y, prediction))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A small affinity model trained for a few iterations with MWSVOIMetric, on the CPU."""
    tmp = tmp_path_factory.mktemp("validation")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        raw, labels = port_test.make_volume(rng, (12, 48, 48))
        paths.append((str(tmp / f"raw{i}.npy"), str(tmp / f"labels{i}.npy")))
        np.save(paths[-1][0], raw)
        np.save(paths[-1][1], labels)
    np.random.seed(0)
    loader = [port.default_segmentation_loader(
        [p[0]], None, [p[1]], None, batch_size=1, patch_shape=PATCH, ndim=3,
        label_transform2=AffinitiesAndLabels(OFFSETS), n_samples=n, num_workers=0) for p, n in zip(paths, (4, 1))]
    model = port.AnisotropicUNet(in_channels=1, out_channels=len(OFFSETS), initial_features=4,
                                 scale_factors=[[1, 2, 2]], final_activation="Sigmoid", device="cpu", seed=0)
    trainer = port.default_segmentation_trainer(
        "mws-metric", model, loader[0], loader[1], loss=dice_on_affinities,
        metric=MWSVOIMetric(OFFSETS, min_seg_size=5), device="cpu", mixed_precision=False, logger=MetricLog,
        save_root=str(tmp))
    trainer.fit(iterations=8)
    return trainer, paths


def test_fit_with_host_metric(trained):
    from torch_em_tpu.metric import MWSVOIMetric as JaxMWSVOIMetric

    trainer, _ = trained
    assert trainer.iteration == 8 and len(trainer.logger.metrics) == 2
    for metric, x, y, pred in trainer.logger.metrics:
        assert isinstance(pred, torch.Tensor)
        expected = JaxMWSVOIMetric(OFFSETS, min_seg_size=5)(pred.numpy(), y.numpy())
        assert np.isfinite(metric) and metric > 0
        assert abs(metric - expected) <= 1e-12, (metric, expected)
    best = port.DefaultTrainer._load_save_dict(os.path.join(trainer.checkpoint_folder, "best.ckpt"))
    assert best["best_metric"] == min(m[0] for m in trainer.logger.metrics)
    rebuilt = port.DefaultTrainer.from_checkpoint(trainer.checkpoint_folder, "latest", device="cpu")
    assert isinstance(rebuilt.metric, MWSVOIMetric) and rebuilt.metric.init_kwargs == trainer.metric.init_kwargs


def test_validate_checkpoint(trained, tmp_path):
    trainer, paths = trained
    kwargs = dict(gpu_ids=("cpu",), block_shape=(8, 32, 32), halo=(2, 8, 8), visualize=False)
    save_path = str(tmp_path / "predictions.h5")
    scores = validation.validate_checkpoint(trainer.checkpoint_folder, metrics=mws_voi, save_path=save_path,
                                            **kwargs)
    predictions = validation.validate_checkpoint(trainer.checkpoint_folder, max_samples=1, **kwargs)
    model = port.utils.get_trainer(trainer.checkpoint_folder, device="cpu").model
    raw, labels = np.load(paths[1][0]), np.load(paths[1][1])
    expected = port.predict_with_halo(raw, model, gpu_ids=["cpu"], block_shape=(8, 32, 32), halo=(2, 8, 8))
    assert len(scores) == 1 and len(predictions) == 1
    np.testing.assert_array_equal(predictions[0], expected)
    assert predictions[0].shape == (len(OFFSETS),) + raw.shape
    assert scores[0] == mws_voi(labels, expected)
    with h5py.File(save_path, "r") as f:
        np.testing.assert_array_equal(f["predictions/sample0"][:], expected)
    samples = list(validation.SampleGenerator(trainer, need_gt=True))
    assert len(samples) == 1 and np.array_equal(samples[0][1], labels)
    with pytest.raises(ImportError, match="napari"):
        validation.validate_checkpoint(trainer.checkpoint_folder, gpu_ids=("cpu",), block_shape=(8, 32, 32),
                                       halo=(2, 8, 8))
    two = validation.validate_checkpoint(trainer.checkpoint_folder, max_samples=1,
                                         **{**kwargs, "gpu_ids": ("cpu", "cpu")})
    np.testing.assert_array_equal(two[0], expected)


def test_validate_checkpoint_cli(trained):
    trainer, _ = trained
    code = ("import sys; sys.argv = ['validate_checkpoint', '-p', sys.argv[1], '-g', 'cpu']\n"
            "from torch_em_tpu_torch.utils.validation import main\nmain()\nprint('validated')\n")
    # the checkpoint names this module's label transform and loss; the module imports the JAX
    # package only inside the tests that compare with it, so that this process need not load it
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, trainer.checkpoint_folder], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "validated"


@pytest.mark.parametrize("kwargs", [dict(spatial_shape=(40, 40)), dict(spatial_shape=(8, 30, 30), n_batches=2),
                                    dict(spatial_shape=(32, 32), with_channels=True, with_background=True,
                                         dtype="int64")])
def test_make_gt(kwargs):
    from torch_em_tpu.utils import test as jax_test

    np.random.seed(5)
    got = port_test.make_gt(**kwargs)
    np.random.seed(5)
    expected = jax_test.make_gt(**kwargs)
    assert got.dtype == expected.dtype
    np.testing.assert_array_equal(got, expected)


def test_test_data_writers(tmp_path):
    from torch_em_tpu.utils import test as jax_test

    for side, module in (("port", port_test), ("jax", jax_test)):
        np.random.seed(3)
        module.create_segmentation_test_data(str(tmp_path / f"{side}.h5"), "raw", "labels", (8, 16, 16), (4, 8, 8))
        np.random.seed(3)
        module.create_image_collection_test_data(str(tmp_path / side), 3, (20, 24), (30, 34))
    with h5py.File(tmp_path / "port.h5", "r") as a, h5py.File(tmp_path / "jax.h5", "r") as b:
        for key in ("raw", "labels"):
            np.testing.assert_array_equal(a[key][:], b[key][:])
            assert a[key].chunks == b[key].chunks
    for sub in ("images", "labels"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert sorted(os.listdir(tmp_path / "port" / sub)) == names and len(names) == 3
        for name in names:
            assert (tmp_path / "port" / sub / name).read_bytes() == (tmp_path / "jax" / sub / name).read_bytes()
