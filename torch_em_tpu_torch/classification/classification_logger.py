"""The classification logger, counterpart of ``torch_em_tpu/classification/classification_logger.py``.

Scalars, sample images and the validation's confusion matrix, written to TensorBoard event files
by the port's own ``utils/tensorboard.py`` (no tensorboardX). The confusion matrix is computed in
numpy with scikit-learn's ``confusion_matrix`` semantics and drawn in numpy as a viridis heat map
(matplotlib's 256-entry table, copied here) with a colour bar beside it; unlike the JAX package's
matplotlib figure it has no axis text, by design.
"""

from typing import Optional

import numpy as np

from ..trainer.logger_base import TorchEmLogger
from ..trainer.tensorboard_logger import _select_2d, make_grid, tensorboard_writer

__all__ = ["ClassificationLogger", "confusion_matrix", "make_confusion_matrix"]

# matplotlib's viridis, cmap(np.arange(256), bytes=True)[:, :3], as hex RGB triples
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
    "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
    "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
    "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
    "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"
), dtype=np.uint8).reshape(256, 3)
CELL = 256  # side of the matrix's square in pixels, before rounding to whole cells
BAR_WIDTH, MARGIN = 16, 8


def confusion_matrix(y_true, y_pred, normalize: Optional[str] = "true") -> np.ndarray:
    """``sklearn.metrics.confusion_matrix(y_true, y_pred, normalize=normalize)``: rows are the
    true classes, columns the predicted ones, over the sorted union of the labels of both; with
    ``normalize`` "true", "pred" or "all" divided by the row, column or whole sum, where an
    empty row or column gives 0."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    if y_true.shape != y_pred.shape:
        raise ValueError(f"y_true and y_pred differ in length: {y_true.size} and {y_pred.size}")
    labels = np.unique(np.concatenate([y_true, y_pred]))
    n = len(labels)
    cm = np.bincount(np.searchsorted(labels, y_true) * n + np.searchsorted(labels, y_pred),
                     minlength=n * n).reshape(n, n)
    if normalize is None:
        return cm
    axes = {"true": 1, "pred": 0, "all": None}
    if normalize not in axes:
        raise ValueError(f"normalize must be 'true', 'pred', 'all' or None, got {normalize!r}")
    with np.errstate(all="ignore"):
        cm = cm / cm.sum(axis=axes[normalize], keepdims=axes[normalize] is not None)
    return np.nan_to_num(cm)


def make_confusion_matrix(y_true, y_pred, normalize: str = "true"):
    """The confusion matrix (rows: true classes) as a (3, H, W) ``uint8`` image: each cell a
    square coloured by viridis over [0, 1], a colour bar from 1 (top) to 0 on the right, on
    white."""
    cm = confusion_matrix(y_true, y_pred, normalize=normalize)
    n = cm.shape[0]
    cell = max(1, CELL // n)
    side = cell * n
    index = np.clip((cm * 256).astype(np.int64), 0, 255)
    matrix = np.repeat(np.repeat(VIRIDIS[index], cell, axis=0), cell, axis=1)
    bar = np.repeat(VIRIDIS[np.linspace(255, 0, side).round().astype(np.int64)][:, None], BAR_WIDTH, axis=1)
    image = np.full((side + 2 * MARGIN, side + BAR_WIDTH + 3 * MARGIN, 3), 255, dtype=np.uint8)
    image[MARGIN: MARGIN + side, MARGIN: MARGIN + side] = matrix
    image[MARGIN: MARGIN + side, 2 * MARGIN + side: 2 * MARGIN + side + BAR_WIDTH] = bar
    return image.transpose(2, 0, 1)


class ClassificationLogger(TorchEmLogger):
    """Scalars every step, the input every ``log_image_interval`` steps, the confusion matrix
    of every validation."""

    def __init__(self, trainer, save_root: Optional[str], **kwargs):
        super().__init__(trainer, save_root)
        self.log_dir, self.tb = tensorboard_writer(trainer, save_root)
        self.log_image_interval = trainer.log_image_interval

    def flush(self):
        self.tb.flush()

    def log_train(self, step, loss, lr, x, y, prediction, log_gradients=False):
        self.tb.add_scalar(tag="train/loss", scalar_value=float(loss), global_step=step)
        self.tb.add_scalar(tag="train/learning_rate", scalar_value=float(lr), global_step=step)
        if step % self.log_image_interval == 0 and x is not None:
            self.tb.add_image(tag="train/input", img_tensor=make_grid([_select_2d(x)]), global_step=step)

    def log_validation(self, step, metric, loss, x, y, prediction, y_true=None, y_pred=None):
        self.tb.add_scalar(tag="validation/loss", scalar_value=float(loss), global_step=step)
        self.tb.add_scalar(tag="validation/metric", scalar_value=float(metric), global_step=step)
        if x is not None:
            self.tb.add_image(tag="validation/input", img_tensor=make_grid([_select_2d(x)]), global_step=step)
        if y_true is not None and y_pred is not None:
            self.tb.add_image(tag="validation/confusion_matrix", img_tensor=make_confusion_matrix(y_true, y_pred),
                              global_step=step)
