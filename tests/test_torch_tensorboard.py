"""TensorBoard event files with neither tensorboardX nor tensorboard (``utils/tensorboard.py``),
the numpy confusion matrix of the classification logger, and the trainers' default loggers.

- CRC-32C: the native op (``ops/native/crc32c.cpp``) and the plain Python version against
  tensorboardX's ``crc32c`` and the check value of ``b"123456789"``, 0xE3069283.
- Files the port writes, read by tensorboard's ``EventAccumulator``, against files tensorboardX
  writes for the same calls: tags, steps, wall times, float32 scalars and PNG bytes equal; the
  port's ``read_events`` reads both, and raises on a flipped byte.
- ``confusion_matrix`` against ``sklearn.metrics.confusion_matrix``, classes missing from one side
  included; the heat map's cells in viridis.
- The default logger of each of the six entry points is the counterpart of the JAX package's
  default, and each trainer fits two steps with its default logger while tensorboardX,
  tensorboard, sklearn and matplotlib are blocked, writing the JAX loggers' tags.
"""

import inspect
import io
import os
import sys

import numpy as np
import pytest
import tensorboardX
import torch
from PIL import Image as PILImage
from sklearn.metrics import confusion_matrix as sklearn_confusion_matrix
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
from tensorboardX.crc32c import crc32c as tensorboardx_crc32c

import torch_em_tpu as jax_package
import torch_em_tpu.classification as jax_classification
import torch_em_tpu.self_training as jax_self_training
import torch_em_tpu_torch as port
import torch_em_tpu_torch.classification as classification
import torch_em_tpu_torch.self_training as self_training
from torch_em_tpu.trainer.spoco_trainer import SPOCOTrainer as JaxSPOCOTrainer
from torch_em_tpu_torch.classification.classification_logger import VIRIDIS, confusion_matrix, make_confusion_matrix
from torch_em_tpu_torch.ops.native import crc32c
from torch_em_tpu_torch.trainer.spoco_trainer import SPOCOTrainer
from torch_em_tpu_torch.utils.tensorboard import Image, SummaryWriter, read_events

BLOCKED = ("tensorboardX", "tensorboard", "sklearn", "matplotlib")


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 63, 1000, 65537])
def test_crc32c_matches_tensorboardx(size):
    data = np.random.default_rng(size).integers(0, 256, size + 3, dtype=np.uint8).tobytes()
    for offset in range(3):  # the native loop's unaligned head
        chunk = data[offset: offset + size]
        assert crc32c.crc32c(chunk) == tensorboardx_crc32c(chunk)
        if size <= 1000:
            assert crc32c.crc32c_reference(chunk) == tensorboardx_crc32c(chunk)


def test_crc32c_check_value():
    assert crc32c.crc32c(b"123456789") == crc32c.crc32c_reference(b"123456789") == 0xE3069283


def _write_both(folder):
    """The same calls through the port's writer and tensorboardX's; returns their folders."""
    rng = np.random.default_rng(0)
    images = {"img/chw_float": (rng.random((3, 20, 30)).astype(np.float32), "CHW"),
              "img/one_channel_uint8": ((rng.random((1, 9, 7)) * 255).astype(np.uint8), "CHW"),
              "img/hw_float64": (rng.random((12, 5)), "HW"),
              "img/hwc_tensor": (torch.from_numpy(rng.random((6, 4, 3)).astype(np.float32)), "HWC")}
    for name, writer_class in (("port", SummaryWriter), ("tensorboardx", tensorboardX.SummaryWriter)):
        writer = writer_class(str(folder / name))
        for step in range(4):
            writer.add_scalar("train/loss", 1.0 / (step + 1), step, walltime=100.0 + step)
            writer.add_scalar("train/learning_rate", torch.tensor(1e-4 * 0.5 ** step), step, walltime=100.5)
            writer.add_scalar("odd tag/ranges", [-3e38, 0.0, 3e-39, np.float64(1e40)][step], step, walltime=101.0)
        for step, (tag, (image, dataformats)) in enumerate(images.items()):
            writer.add_image(tag, image, 10 * step, walltime=200.0 + step, dataformats=dataformats)
        writer.close()
    return folder / "port", folder / "tensorboardx"


def _accumulated(folder):
    acc = EventAccumulator(str(folder), size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    scalars = {tag: [(e.wall_time, e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}
    images = {tag: [(e.wall_time, e.step, e.width, e.height, e.encoded_image_string) for e in acc.Images(tag)]
              for tag in acc.Tags()["images"]}
    return scalars, images


def test_event_files_equal_tensorboardx(tmp_path):
    ours, theirs = _write_both(tmp_path)
    got, expected = _accumulated(ours), _accumulated(theirs)
    assert got == expected
    scalars, images = got
    assert sorted(scalars) == ["odd_tag/ranges", "train/learning_rate", "train/loss"]
    assert [v for _, _, v in scalars["train/loss"]] == [np.float32(1 / (s + 1)) for s in range(4)]
    assert [v for _, _, v in scalars["odd_tag/ranges"]][-1] == np.inf
    assert len(images) == 4 and all(len(v) == 1 for v in images.values())
    # one file each, equal byte for byte after the first record (its wall time is the writer's)
    (ours_file,), (theirs_file,) = os.listdir(ours), os.listdir(theirs)
    assert ours_file.startswith("events.out.tfevents.")
    ours_bytes, theirs_bytes = (open(os.path.join(f, n), "rb").read() for f, n in ((ours, ours_file),
                                                                                     (theirs, theirs_file)))
    first = 16 + ours_bytes[0]
    assert ours_bytes[first:] == theirs_bytes[first:]


def test_read_events_reads_both(tmp_path):
    ours, theirs = _write_both(tmp_path)
    got, expected = list(read_events(str(ours))), list(read_events(str(theirs)))
    assert got == expected
    assert [(step, tag) for _, step, tag, _ in got[:3]] == [(0, "train/loss"), (0, "train/learning_rate"),
                                                            (0, "odd_tag/ranges")]
    image = got[-1][3]
    assert isinstance(image, Image) and (image.height, image.width, image.colorspace) == (6, 4, 3)
    decoded = np.asarray(PILImage.open(io.BytesIO(image.encoded_image_string)))
    assert decoded.shape == (6, 4, 3)


@pytest.mark.parametrize("where", ["length", "length_crc", "data", "data_crc"])
def test_read_events_raises_on_a_flipped_byte(tmp_path, where):
    ours, _ = _write_both(tmp_path)
    (name,) = os.listdir(ours)
    path = ours / name
    data = bytearray(path.read_bytes())
    first = 16 + data[0]  # the second record starts here
    length = int.from_bytes(data[first: first + 8], "little")
    offset = {"length": 0, "length_crc": 9, "data": 12 + length // 2, "data_crc": 12 + length + 1}[where]
    data[first + offset] ^= 0x10
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC|cut short"):
        list(read_events(str(path)))


def test_read_events_raises_on_a_malformed_event(tmp_path):
    """A record whose framing and CRCs hold but whose Event has a field of another wire type."""
    writer = SummaryWriter(str(tmp_path))
    writer.add_scalar("a", 1.0, 3)
    writer._write(bytes([1 << 3 | 0, 5]))  # wall_time (field 1) as a varint
    writer.close()
    with pytest.raises(ValueError, match="does not parse"):
        list(read_events(str(tmp_path)))


@pytest.mark.parametrize("y_true, y_pred", [
    ([0, 1, 2, 2, 1, 0, 0], [0, 2, 2, 2, 1, 1, 0]),
    ([0, 1, 1, 3], [0, 1, 2, 2]),  # 2 never true, 3 never predicted
    ([5, 5, 7], [5, 5, 5]),  # labels that are not 0..n-1
    ([1, 1, 1], [1, 1, 1]),
])
@pytest.mark.parametrize("normalize", ["true", "pred", "all", None])
def test_confusion_matrix_matches_sklearn(y_true, y_pred, normalize):
    got = confusion_matrix(np.array(y_true), np.array(y_pred), normalize=normalize)
    np.testing.assert_array_equal(got, sklearn_confusion_matrix(y_true, y_pred, normalize=normalize))


def test_confusion_matrix_image():
    y_true, y_pred = np.array([0, 1, 1, 3]), np.array([0, 1, 2, 2])
    image = make_confusion_matrix(y_true, y_pred)
    cm = sklearn_confusion_matrix(y_true, y_pred, normalize="true")
    n, cell, margin = 4, 256 // 4, 8
    assert image.dtype == np.uint8 and image.shape == (3, n * cell + 2 * margin, n * cell + 16 + 3 * margin)
    hwc = image.transpose(1, 2, 0)
    for i in range(n):
        for j in range(n):
            block = hwc[margin + i * cell: margin + (i + 1) * cell, margin + j * cell: margin + (j + 1) * cell]
            assert (block == VIRIDIS[min(int(cm[i, j] * 256), 255)]).all()
    bar = hwc[margin: margin + n * cell, 2 * margin + n * cell]
    assert (bar[0] == VIRIDIS[255]).all() and (bar[-1] == VIRIDIS[0]).all()
    assert (hwc[:margin] == 255).all()


def _default_logger(entry):
    """The default of ``entry``'s ``logger`` argument, from the first class of its MRO that names it."""
    for owner in (entry.__mro__ if inspect.isclass(entry) else (entry,)):
        parameter = inspect.signature(owner).parameters.get("logger")
        if parameter is not None:
            return parameter.default
    raise AssertionError(f"{entry} takes no logger")


ENTRY_POINTS = {
    "DefaultTrainer": (port.DefaultTrainer, jax_package.DefaultTrainer),
    "default_segmentation_trainer": (port.default_segmentation_trainer, jax_package.default_segmentation_trainer),
    "SPOCOTrainer": (SPOCOTrainer, JaxSPOCOTrainer),
    "MeanTeacherTrainer": (self_training.MeanTeacherTrainer, jax_self_training.MeanTeacherTrainer),
    "UniMatchv2Trainer": (self_training.UniMatchv2Trainer, jax_self_training.UniMatchv2Trainer),
    "default_classification_trainer": (classification.default_classification_trainer,
                                       jax_classification.default_classification_trainer),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_default_logger_is_the_jax_defaults_counterpart(name):
    ours, theirs = (_default_logger(entry) for entry in ENTRY_POINTS[name])
    assert theirs is not None and ours is not None
    assert (ours.__module__, ours.__qualname__) == (theirs.__module__.replace("torch_em_tpu", "torch_em_tpu_torch"),
                                                    theirs.__qualname__)


def _segmentation_data(n_train=2):
    rng = np.random.default_rng(1)
    raw = rng.normal(size=(48, 48)).astype(np.float32)
    labels = np.zeros((48, 48), dtype=np.float32)
    for k, (y, x) in enumerate([(2, 3), (20, 5), (8, 25), (30, 28)], 1):
        labels[y: y + 12, x: x + 12] = k
    train = port.SegmentationDataset(raw, None, labels, None, patch_shape=(32, 32), n_samples=n_train)
    val = port.SegmentationDataset(raw, None, labels, None, patch_shape=(32, 32), n_samples=1)
    return port.DataLoader(train), port.DataLoader(val)


def _self_training_loaders():
    from torch_em_tpu_torch.data import RawDataset
    from torch_em_tpu_torch.transforms import get_default_mean_teacher_augmentations

    raw = np.random.default_rng(2).normal(size=(64, 64)).astype(np.float32)
    aug = get_default_mean_teacher_augmentations(p=0.5)
    return [port.DataLoader(RawDataset(raw, None, (32, 32), augmentations=(aug, aug), n_samples=n), batch_size=2)
            for n in (4, 2)]


def _build(name, save_root):
    common = dict(device="cpu", mixed_precision=False, save_root=save_root, log_image_interval=1)
    model = port.UNet2d(1, 1, depth=2, initial_features=4, final_activation="Sigmoid", device="cpu")
    if name in ("DefaultTrainer", "default_segmentation_trainer"):
        train, val = _segmentation_data()
        if name == "DefaultTrainer":
            return port.DefaultTrainer(name, train, val, model, loss=port.DiceLoss(), metric=port.DiceLoss(), **common)
        return port.default_segmentation_trainer(name, model, train, val, **common)
    if name == "SPOCOTrainer":
        train, val = _segmentation_data()
        model = port.UNet2d(1, 4, depth=2, initial_features=4, device="cpu")
        return SPOCOTrainer(name=name, model=model, train_loader=train, val_loader=val,
                            loss=port.loss.SPOCOLoss(0.75, 2.0), metric=port.loss.ContrastiveLoss(0.75, 2.0), **common)
    if name == "default_classification_trainer":
        rng = np.random.default_rng(3)
        data = [rng.normal(loc=i % 3, size=(1, 16, 16, 16)).astype(np.float32) for i in range(6)]
        target = np.arange(6) % 3
        train = classification.default_classification_loader(data[:4], target[:4], batch_size=2)
        val = classification.default_classification_loader(data[4:], target[4:], batch_size=2)
        return classification.default_classification_trainer(name, port.resnet3d_18(1, 3, device="cpu", seed=1),
                                                             train, val, **common)
    unsupervised_train, unsupervised_val = _self_training_loaders()
    kwargs = dict(name=name, model=model, unsupervised_train_loader=unsupervised_train,
                  unsupervised_val_loader=unsupervised_val,
                  pseudo_labeler=self_training.DefaultPseudoLabeler(confidence_threshold=0.9),
                  optimizer=port.OptimizerSpec("adamw", lr=1e-3), **common)
    if name == "MeanTeacherTrainer":
        return self_training.MeanTeacherTrainer(
            unsupervised_loss=self_training.DefaultSelfTrainingLoss(),
            unsupervised_loss_and_metric=self_training.DefaultSelfTrainingLossAndMetric(), **kwargs)
    return self_training.UniMatchv2Trainer(
        augmenter=self_training.UniMatchv2Augmenters(2), unsupervised_loss=self_training.DefaultUnimatchLoss(),
        unsupervised_loss_and_metric=self_training.DefaultUnimatchLossAndMetric(), **kwargs)


# the tags each trainer's default logger writes in two steps and one validation, as the JAX loggers name them
SEGMENTATION_TAGS = {"train/loss", "train/learning_rate", "validation/loss", "validation/metric", "train/input",
                     "train/target", "train/prediction", "validation/input", "validation/target",
                     "validation/prediction"}
SELF_TRAINING_TAGS = {"train/unsupervised/loss", "train/learning_rate", "train/unsupervised/overview",
                      "validation/unsupervised/loss", "validation/unsupervised/metric",
                      "validation/unsupervised/overview"}
EXPECTED_TAGS = {
    "DefaultTrainer": SEGMENTATION_TAGS, "default_segmentation_trainer": SEGMENTATION_TAGS,
    "SPOCOTrainer": SEGMENTATION_TAGS,
    "MeanTeacherTrainer": SELF_TRAINING_TAGS | {"train/confidence_threshold"},
    "UniMatchv2Trainer": SELF_TRAINING_TAGS,
    "default_classification_trainer": {"train/loss", "train/learning_rate", "train/input", "validation/loss",
                                       "validation/metric", "validation/input", "validation/confusion_matrix"},
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_trainer_fits_with_its_default_logger_and_the_packages_blocked(name, tmp_path, monkeypatch):
    for package in BLOCKED:
        monkeypatch.setitem(sys.modules, package, None)
    torch.manual_seed(0)
    trainer = _build(name, str(tmp_path))
    assert trainer.logger_class is _default_logger(ENTRY_POINTS[name][0])
    trainer.fit(iterations=2)
    events = list(read_events(str(tmp_path / "logs" / name)))
    assert {tag for *_, tag, _ in events} == EXPECTED_TAGS[name]
    loss_tag = "train/unsupervised/loss" if name in ("MeanTeacherTrainer", "UniMatchv2Trainer") else "train/loss"
    losses = [(step, value) for _, step, tag, value in events if tag == loss_tag]
    assert [step for step, _ in losses] == [0, 1] and all(np.isfinite(v) for _, v in losses)
    assert all(isinstance(v, Image) and v.encoded_image_string.startswith(b"\x89PNG")
               for *_, tag, v in events if tag.endswith(("input", "overview", "confusion_matrix")))
