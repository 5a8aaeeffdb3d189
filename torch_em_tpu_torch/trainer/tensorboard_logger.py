"""Tensorboard logging, counterpart of ``torch_em_tpu/trainer/tensorboard_logger.py``.

Writes TensorBoard event files, as the JAX package does with tensorboardX, through the port's
own ``utils/tensorboard.py`` (neither tensorboardX nor tensorboard is needed; images need PIL),
into ``<save_root>/logs/<name>`` (``./logs/<name>`` without a ``save_root``). Scalars are logged
every iteration and image grids every ``log_image_interval`` iterations; the trainer hands over
device tensors, which are read here, and calls ``flush`` after each batch of logger calls, each
validation and the end of ``fit``.
The predictions of an embedding loss (``loss.EMBEDDING_LOSSES``) with more
than three channels are shown as their first three principal components.
"""

import os
from typing import Optional

import numpy as np
import torch

from ..utils.tensorboard import SummaryWriter
from .logger_base import TorchEmLogger

__all__ = ["TensorboardLogger", "make_grid", "embedding_pca"]


def tensorboard_writer(trainer, save_root: Optional[str]):
    """The log folder of ``trainer`` and a ``SummaryWriter`` into it."""
    log_dir = f"./logs/{trainer.name}" if save_root is None else os.path.join(save_root, "logs", trainer.name)
    return log_dir, SummaryWriter(log_dir)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def make_grid(images, pad: int = 2):
    """Assemble a row of 2D images ((C,) H, W each) into one (3, H, W') grid, each scaled to [0, 1]."""
    rows = []
    for im in images:
        im = _to_numpy(im).astype("float32")
        if im.ndim == 2:
            im = im[None]
        lo, hi = im.min(), im.max()
        im = (im - lo) / (hi - lo + 1e-7)
        if im.shape[0] == 1:
            im = np.repeat(im, 3, axis=0)
        elif im.shape[0] != 3:
            im = np.repeat(im[:1], 3, axis=0)
        rows.append(np.pad(im, ((0, 0), (pad, pad), (pad, pad))))
    return np.concatenate(rows, axis=2)


def _select_2d(x):
    """The first sample of a batch (N, C, [D,] H, W) as a displayable (C, H, W): a 3D
    sample shows its central slice."""
    im = _to_numpy(x)[0]
    if im.ndim == 4:
        im = im[:, im.shape[1] // 2]
    return im


def embedding_pca(embeddings: np.ndarray, n_components: int = 3, as_rgb: bool = True) -> np.ndarray:
    """Project an embedding image (E, *spatial) onto its first principal components; with
    ``as_rgb`` each component is scaled to [0, 1]."""
    e = embeddings.shape[0]
    flat = embeddings.reshape(e, -1).astype("float64")
    flat = flat - flat.mean(axis=1, keepdims=True)
    u, _, _ = np.linalg.svd(flat @ flat.T / flat.shape[1])
    proj = (u[:, :n_components].T @ flat).reshape((n_components,) + embeddings.shape[1:])
    if as_rgb:
        lo = proj.min(axis=tuple(range(1, proj.ndim)), keepdims=True)
        hi = proj.max(axis=tuple(range(1, proj.ndim)), keepdims=True)
        proj = (proj - lo) / (hi - lo + 1e-7)
    return proj.astype("float32")


class TensorboardLogger(TorchEmLogger):
    """Scalars every iteration; raw, target and prediction grids every ``log_image_interval``."""

    def __init__(self, trainer, save_root: Optional[str], **kwargs):
        super().__init__(trainer, save_root)
        self.log_dir, self.tb = tensorboard_writer(trainer, save_root)
        self.log_image_interval = trainer.log_image_interval
        from ..loss import EMBEDDING_LOSSES

        self.have_embedding_loss = type(getattr(trainer, "loss", None)) in EMBEDDING_LOSSES

    def flush(self):
        self.tb.flush()

    def log_images(self, step, x, y, prediction, name, gradients=None):
        self.tb.add_image(tag=f"{name}/input", img_tensor=make_grid([_select_2d(x)]), global_step=step)
        target = _select_2d(y)
        pred = _select_2d(prediction[0] if isinstance(prediction, (list, tuple)) else prediction)
        if self.have_embedding_loss and pred.shape[0] > 3:
            pred = embedding_pca(pred)
        # up to 4 channels of target and prediction side by side
        self.tb.add_image(tag=f"{name}/target", global_step=step,
                          img_tensor=make_grid([target[i: i + 1] for i in range(min(target.shape[0], 4))]))
        self.tb.add_image(tag=f"{name}/prediction", global_step=step,
                          img_tensor=make_grid([pred[i: i + 1] for i in range(min(pred.shape[0], 4))]))
        if gradients is not None:
            grad = _select_2d(gradients)
            self.tb.add_image(tag=f"{name}/gradients", img_tensor=make_grid([grad[:1]]), global_step=step)

    def log_train(self, step, loss, lr, x, y, prediction, log_gradients=False):
        self.tb.add_scalar(tag="train/loss", scalar_value=float(loss), global_step=step)
        self.tb.add_scalar(tag="train/learning_rate", scalar_value=float(lr), global_step=step)
        if step % self.log_image_interval == 0 and x is not None:
            self.log_images(step, x, y, prediction, "train")

    def log_validation(self, step, metric, loss, x, y, prediction):
        self.tb.add_scalar(tag="validation/loss", scalar_value=float(loss), global_step=step)
        self.tb.add_scalar(tag="validation/metric", scalar_value=float(metric), global_step=step)
        if x is not None:
            self.log_images(step, x, y, prediction, "validation")
