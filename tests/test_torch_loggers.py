"""The port's trainer loggers against the JAX package's.

``TensorboardLogger`` writes with the port's own ``utils/tensorboard.py``, the
JAX package's with tensorboardX: the same numpy inputs (a batch of raw images, labels and an 8-channel embedding
prediction of an embedding loss) must give the same scalars and the same
encoded images in the event files, read back with tensorboard's
``EventAccumulator``; the PCA view and the grids are also compared as
arrays (1e-6). ``WandbLogger`` runs against a fake ``wandb`` module, since
neither machine has wandb.
"""

import sys
import types

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from torch_em_tpu.loss import SPOCOLoss as JaxSPOCOLoss
from torch_em_tpu.trainer import tensorboard_logger as jax_tb
from torch_em_tpu_torch import loss
from torch_em_tpu_torch.trainer import TensorboardLogger, WandbLogger
from torch_em_tpu_torch.trainer import tensorboard_logger as tb


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 1, 24, 20)).astype(np.float32)
    y = rng.integers(0, 5, size=(2, 1, 24, 20)).astype(np.float32)
    pred = rng.normal(size=(2, 8, 24, 20)).astype(np.float32)
    return x, y, pred


def _events(folder):
    acc = EventAccumulator(str(folder), size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    scalars = {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}
    images = {tag: [(e.step, e.encoded_image_string) for e in acc.Images(tag)] for tag in acc.Tags()["images"]}
    return scalars, images


def test_embedding_pca_and_grid_match_jax():
    x, y, pred = _batch()
    np.testing.assert_allclose(tb.embedding_pca(pred[0]), jax_tb.embedding_pca(pred[0]), rtol=0, atol=1e-6)
    assert tb.embedding_pca(pred[0]).shape == (3, 24, 20)
    expected = jax_tb.make_grid([y[0, 0], pred[0, :3]])
    np.testing.assert_allclose(tb.make_grid([torch.from_numpy(y[0, 0]), torch.from_numpy(pred[0, :3])]), expected,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("embedding", [True, False])
def test_tensorboard_logger_writes_what_jax_writes(tmp_path, embedding):
    x, y, pred = _batch()
    port_loss = loss.SPOCOLoss(0.75, 2.0) if embedding else loss.DiceLoss()
    jax_loss = JaxSPOCOLoss(0.75, 2.0) if embedding else None
    ours = TensorboardLogger(types.SimpleNamespace(name="run", log_image_interval=2, loss=port_loss),
                             str(tmp_path / "port"))
    theirs = jax_tb.TensorboardLogger(types.SimpleNamespace(name="run", log_image_interval=2, loss=jax_loss),
                                      str(tmp_path / "jax"))
    assert ours.have_embedding_loss == embedding
    for step in range(3):
        ours.log_train(step, torch.tensor(1.0 / (step + 1)), 1e-4, torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(pred))
        theirs.log_train(step, 1.0 / (step + 1), 1e-4, x, y, pred)
    ours.log_validation(3, 0.25, 0.5, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(pred))
    theirs.log_validation(3, 0.25, 0.5, x, y, pred)
    for logger in (ours, theirs):
        logger.tb.close()
    got, expected = _events(tmp_path / "port" / "logs" / "run"), _events(tmp_path / "jax" / "logs" / "run")
    assert got == expected
    scalars, images = got
    assert [s for s, _ in scalars["train/loss"]] == [0, 1, 2] and scalars["validation/metric"] == [(3, 0.25)]
    # images every second step, and at validation
    assert [s for s, _ in images["train/prediction"]] == [0, 2] and len(images["validation/prediction"]) == 1


def test_tensorboard_logger_needs_tensorboardx(tmp_path, monkeypatch):
    """The logger needs no tensorboardX: with it blocked, the port's own writer writes what
    tensorboard's reader reads back."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    x, y, pred = _batch()
    logger = TensorboardLogger(types.SimpleNamespace(name="run", log_image_interval=1, loss=None), str(tmp_path))
    logger.log_train(0, torch.tensor(0.5), 1e-4, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(pred))
    logger.log_validation(1, 0.25, 0.75, x, y, pred)
    logger.tb.close()
    scalars, images = _events(tmp_path / "logs" / "run")
    assert scalars["train/loss"] == [(0, 0.5)] and scalars["validation/loss"] == [(1, 0.75)]
    assert set(images) == {"train/input", "train/target", "train/prediction", "validation/input",
                           "validation/target", "validation/prediction"}


def test_trainer_logs_to_tensorboard(tmp_path):
    import torch_em_tpu_torch as port

    rng = np.random.default_rng(1)
    raw = rng.normal(size=(32, 32)).astype(np.float32)
    labels = (raw > 0).astype(np.float32)
    ds = port.SegmentationDataset(raw, None, labels, None, patch_shape=(16, 16), n_samples=2)
    model = port.UNet2d(1, 1, depth=1, initial_features=2, final_activation="Sigmoid", device="cpu")
    trainer = port.default_segmentation_trainer(
        "tb", model, port.DataLoader(ds), port.DataLoader(ds), device="cpu", mixed_precision=False,
        logger=TensorboardLogger, log_image_interval=1, save_root=str(tmp_path))
    trainer.fit(iterations=2)
    trainer.logger.tb.close()
    scalars, images = _events(tmp_path / "logs" / "tb")
    assert [s for s, _ in scalars["train/loss"]] == [0, 1] and len(scalars["validation/loss"]) == 1
    assert {"train/input", "train/target", "train/prediction", "validation/input"} <= set(images)


class _FakeRun:
    def __init__(self, **kwargs):
        self.kwargs = kwargs
        self.name, self.id = "fake-run", "abc123"
        self.logged = []

    def log(self, values, step):
        self.logged.append((step, values))


def _fake_wandb():
    module = types.ModuleType("wandb")
    module.runs = []

    def init(**kwargs):
        module.runs.append(_FakeRun(**kwargs))
        return module.runs[-1]

    module.init = init
    module.Image = lambda array: ("image", np.asarray(array).shape)
    return module


def test_wandb_logger_with_a_fake_wandb(monkeypatch):
    fake = _fake_wandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    trainer = types.SimpleNamespace(name=None, id_=None, log_image_interval=2)
    logger = WandbLogger(trainer, None, project_name="p", mode="offline", config={"a": 1})
    assert fake.runs[0].kwargs == {"project": "p", "name": None, "mode": "offline", "config": {"a": 1}}
    assert (trainer.name, trainer.id_) == ("fake-run", "abc123") and logger.get_wandb() is fake
    x, y, pred = _batch()
    logger.log_train(0, torch.tensor(0.5), 1e-4, torch.from_numpy(x), y, pred)
    logger.log_train(1, 0.25, 1e-4, torch.from_numpy(x), y, pred)
    logger.log_validation(2, 0.1, 0.2, x, y, pred)
    assert fake.runs[0].logged == [
        (0, {"train/loss": 0.5, "train/learning_rate": 1e-4}), (0, {"train/input": ("image", (24, 20))}),
        (1, {"train/loss": 0.25, "train/learning_rate": 1e-4}),
        (2, {"validation/loss": 0.2, "validation/metric": 0.1})]


def test_wandb_logger_needs_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError, match="wandb"):
        WandbLogger(types.SimpleNamespace(name="run", log_image_interval=1), None)
