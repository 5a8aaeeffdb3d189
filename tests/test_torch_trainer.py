"""The port's DefaultTrainer: fitting, checkpoints, resume and rebuild.

These mirror ``tests/test_trainer.py`` of the JAX package on the port alone,
on the CPU, with a small AnisotropicUNet (two levels, four features) over
seeded ``.npy`` volumes. Every trainer writes under pytest's ``tmp_path``.
"""

import os

import numpy as np
import pytest
import torch

from torch_em_tpu_torch import (
    AnisotropicUNet, DataLoader, DefaultTrainer, SegmentationDataset, default_segmentation_trainer,
)
from torch_em_tpu_torch.loss import DiceLoss
from torch_em_tpu_torch.ops.device import DeviceAffinityTransform
from torch_em_tpu_torch.transforms import AffinityTransform, connected_components
from torch_em_tpu_torch.trainer import OptimizerSpec, TorchEmLogger

MODEL = dict(in_channels=1, out_channels=1, scale_factors=[[1, 2, 2], [2, 2, 2]],
             initial_features=4, final_activation="Sigmoid", anisotropic_kernel=True)
PATCH = (4, 16, 16)


@pytest.fixture
def data(tmp_path):
    rng = np.random.default_rng(0)
    raw = rng.normal(size=(8, 32, 32)).astype(np.float32)
    np.save(tmp_path / "raw.npy", raw)
    np.save(tmp_path / "labels.npy", (raw > 0.3).astype(np.float32))
    return str(tmp_path / "raw.npy"), str(tmp_path / "labels.npy")


def _loaders(data, n_train=4, n_val=2):
    raw, labels = data
    train = SegmentationDataset(raw, None, labels, None, patch_shape=PATCH, n_samples=n_train)
    val = SegmentationDataset(raw, None, labels, None, patch_shape=PATCH, n_samples=n_val)
    return DataLoader(train, batch_size=1), DataLoader(val, batch_size=1)


def _trainer(data, tmp_path, name="test", seed=0, **kwargs):
    train, val = _loaders(data)
    model = AnisotropicUNet(**MODEL, device="cpu", seed=seed)
    kwargs = dict(dict(learning_rate=1e-3, mixed_precision=False, device="cpu"), **kwargs)
    return default_segmentation_trainer(name, model, train, val, save_root=str(tmp_path), **kwargs)


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def _assert_same_params(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(), err_msg=key)


def test_fit_creates_checkpoints(data, tmp_path):
    trainer = _trainer(data, tmp_path)
    trainer.fit(iterations=8)
    assert trainer.iteration == 8 and trainer.epoch == 2
    folder = tmp_path / "checkpoints" / "test"
    assert (folder / "latest.ckpt").is_file() and (folder / "best.ckpt").is_file()
    save_dict = torch.load(folder / "latest.ckpt", weights_only=True)
    for key in ("iteration", "epoch", "best_epoch", "best_metric", "current_metric", "train_time",
                "model_state", "optimizer_state", "init", "scheduler_state"):
        assert key in save_dict
    assert save_dict["iteration"] == 8


def test_fit_with_epochs(data, tmp_path):
    trainer = _trainer(data, tmp_path)
    trainer.fit(epochs=2)
    assert trainer.epoch == 2 and trainer.iteration == 8


def test_resume_equals_uninterrupted_training(data, tmp_path):
    np.random.seed(0)
    straight = _trainer(data, tmp_path / "a")
    straight.fit(iterations=8)

    np.random.seed(0)
    first = _trainer(data, tmp_path / "b")
    first.fit(iterations=4)
    resumed = _trainer(data, tmp_path / "b")
    resumed.fit(iterations=4, load_from_checkpoint="latest")
    assert resumed.iteration == 8
    assert resumed.current_metric == straight.current_metric
    _assert_same_params(_params(resumed), _params(straight))


def test_from_checkpoint_roundtrip(data, tmp_path):
    trainer = _trainer(data, tmp_path)
    trainer.fit(iterations=4)
    restored = DefaultTrainer.from_checkpoint(str(tmp_path / "checkpoints" / "test"), "latest",
                                              device="cpu")
    assert restored.iteration == 4
    assert restored.train_loader.batch_size == trainer.train_loader.batch_size
    assert isinstance(restored.loss, DiceLoss) and restored.optimizer.lr == 1e-3
    assert restored.model.init_kwargs == trainer.model.init_kwargs
    _assert_same_params(_params(restored), _params(trainer))
    restored.fit(iterations=2)
    assert restored.iteration == 6


def test_overwrite_training_guard(data, tmp_path):
    trainer = _trainer(data, tmp_path)
    trainer.fit(iterations=8)
    again = _trainer(data, tmp_path)
    again.fit(iterations=8, overwrite_training=False)
    assert again.iteration == 0  # training skipped
    with pytest.raises(ValueError, match="at the same time"):
        again.fit(iterations=8, overwrite_training=False, load_from_checkpoint="latest")


def test_save_every_kth_epoch(data, tmp_path):
    trainer = _trainer(data, tmp_path)
    trainer.fit(epochs=2, save_every_kth_epoch=1)
    folder = tmp_path / "checkpoints" / "test"
    assert (folder / "epoch-1.ckpt").is_file() and (folder / "epoch-2.ckpt").is_file()


def test_early_stopping(data, tmp_path):
    trainer = _trainer(data, tmp_path, early_stopping=0, learning_rate=0.0)
    trainer.fit(epochs=3)
    # with lr 0 the metric never improves, so the second epoch stops the run
    assert trainer.epoch == 1 and trainer.iteration == 8


def test_steps_per_execution_runs_steps_one_by_one(data, tmp_path):
    np.random.seed(1)
    per_step = _trainer(data, tmp_path / "a")
    per_step.fit(iterations=6)
    np.random.seed(1)
    chunked = _trainer(data, tmp_path / "b", steps_per_execution=4)
    chunked.fit(iterations=6)
    assert chunked.iteration == 6
    _assert_same_params(_params(chunked), _params(per_step))


def test_mixed_precision_keeps_float32_parameters(data, tmp_path):
    trainer = _trainer(data, tmp_path, mixed_precision=True)
    seen = []
    hook = trainer.model.encoder.register_forward_pre_hook(lambda m, args: seen.append(args[0].dtype))
    trainer.fit(iterations=2)
    hook.remove()
    assert seen and all(dtype == torch.bfloat16 for dtype in seen)
    assert trainer.model.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())


def invert_labels(y):
    return 1 - y


class _RecordingLogger(TorchEmLogger):
    def __init__(self, trainer, save_root, **kwargs):
        super().__init__(trainer, save_root)
        self.train, self.validation = [], []

    def log_train(self, step, loss, lr, x, y, prediction, log_gradients=False):
        self.train.append((step, loss, lr, x is not None))

    def log_validation(self, step, metric, loss, x, y, prediction):
        self.validation.append((step, metric, loss))


def test_logger_and_device_label_transform(data, tmp_path):
    trainer = _trainer(data, tmp_path, logger=_RecordingLogger, log_image_interval=3,
                       device_label_transform=invert_labels)
    seen = []
    loss = trainer.loss
    trainer.loss = lambda pred, y: (seen.append(float(y.mean())), loss(pred, y))[1]
    trainer.fit(iterations=4)
    assert [s for s, _, _, _ in trainer.logger.train] == [0, 1, 2, 3]
    assert [images for _, _, _, images in trainer.logger.train] == [True, False, False, True]
    assert all(np.isfinite(v) for _, v, _, _ in trainer.logger.train)
    assert len(trainer.logger.validation) == 1
    # the loss sees the transformed labels, whose mean is 1 - the raw labels' mean
    raw_mean = np.load(data[1]).mean()
    assert 0 < np.mean(seen) and abs(np.mean(seen) - (1 - raw_mean)) < 0.2


def test_device_affinity_transform_survives_a_checkpoint(tmp_path):
    """Instance labels (connected components of a threshold) through
    DeviceAffinityTransform inside the step; from_checkpoint rebuilds the transform
    and the host AffinityTransform gives the same targets."""
    rng = np.random.default_rng(1)
    raw = rng.normal(size=(8, 32, 32)).astype(np.float32)
    np.save(tmp_path / "raw.npy", raw)
    np.save(tmp_path / "labels.npy", connected_components(raw > 0.3))
    data = str(tmp_path / "raw.npy"), str(tmp_path / "labels.npy")
    offsets = [[-1, 0, 0], [0, -1, 0]]
    model = AnisotropicUNet(**dict(MODEL, out_channels=2), device="cpu", seed=0)
    train, val = _loaders(data)
    trainer = default_segmentation_trainer(
        "affinities", model, train, val, save_root=str(tmp_path), learning_rate=1e-3,
        mixed_precision=False, device="cpu", device_label_transform=DeviceAffinityTransform(offsets))
    trainer.fit(iterations=3)
    restored = DefaultTrainer.from_checkpoint(str(tmp_path / "checkpoints" / "affinities"), "latest",
                                              device="cpu")
    assert isinstance(restored.device_label_transform, DeviceAffinityTransform)
    assert restored.device_label_transform.init_kwargs == {
        "offsets": offsets, "ignore_label": None, "add_binary_target": False, "add_mask": False}
    _assert_same_params(_params(restored), _params(trainer))
    _, y = next(iter(restored.train_loader))
    targets = restored.device_label_transform(y)
    expected = np.stack([AffinityTransform(offsets)(sample[0]) for sample in y.numpy()])
    np.testing.assert_array_equal(targets.numpy(), expected)
    restored.fit(iterations=2)
    assert restored.iteration == 5


def test_trainer_rejects_bad_arguments(data, tmp_path):
    train, val = _loaders(data)
    model = AnisotropicUNet(**MODEL, device="cpu")
    with pytest.raises(TypeError, match="OptimizerSpec"):
        DefaultTrainer("x", train, val, model, DiceLoss(), optimizer="adamw", device="cpu")
    trainer = DefaultTrainer("x", train, val, model, DiceLoss(), OptimizerSpec("sgd", lr=0.1),
                             metric=None, device="cpu", save_root=str(tmp_path))
    with pytest.raises(ValueError, match="metric"):
        trainer.fit(iterations=1)
    trainer.metric = DiceLoss()
    with pytest.raises(ValueError, match="Exactly one"):
        trainer.fit(iterations=1, epochs=1)
    assert not os.path.exists(tmp_path / "checkpoints")
