"""The classification logger, counterpart of ``torch_em_tpu/classification/classification_logger.py``.

Scalars, sample images and the validation's confusion matrix, written with
tensorboardX. tensorboardX, sklearn and matplotlib are imported when the
logger is built (the card's machine has none of them; without one the
constructor raises an ``ImportError`` that names it).
"""

import os
from typing import Optional

import numpy as np

from ..trainer.logger_base import TorchEmLogger
from ..trainer.tensorboard_logger import _select_2d, make_grid

__all__ = ["ClassificationLogger", "make_confusion_matrix"]


def make_confusion_matrix(y_true, y_pred, normalize: str = "true"):
    """The confusion matrix (rows: true classes) as a (3, H, W) image."""
    from sklearn.metrics import confusion_matrix
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = confusion_matrix(y_true, y_pred, normalize=normalize)
    fig, ax = plt.subplots()
    im = ax.imshow(cm, cmap="viridis", vmin=0, vmax=1)
    ax.set_xlabel("prediction")
    ax.set_ylabel("truth")
    fig.colorbar(im)
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return buf.transpose(2, 0, 1)


class ClassificationLogger(TorchEmLogger):
    """Scalars every step, the input every ``log_image_interval`` steps, the confusion matrix
    of every validation."""

    def __init__(self, trainer, save_root: Optional[str], **kwargs):
        super().__init__(trainer, save_root)
        for package in ("tensorboardX", "sklearn", "matplotlib"):
            try:
                __import__(package)
            except ImportError as e:
                raise ImportError(f"The ClassificationLogger needs the {package} package, which is not installed; "
                                  "pass logger=None or another logger.") from e
        from tensorboardX import SummaryWriter

        self.log_dir = f"./logs/{trainer.name}" if save_root is None else os.path.join(save_root, "logs", trainer.name)
        os.makedirs(self.log_dir, exist_ok=True)
        self.tb = SummaryWriter(self.log_dir)
        self.log_image_interval = trainer.log_image_interval

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
