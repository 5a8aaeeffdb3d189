"""Tensorboard logging for self-training.

Counterpart of ``torch_em_tpu/self_training/logger.py`` (torch-em's
``self_training/logger.py``): the supervised, unsupervised and combined
losses, the learning rate, the confidence threshold, and image panels with
the pseudo-labels and their filter. It writes TensorBoard event files
through the port's own ``utils/tensorboard.py``, as ``TensorboardLogger``
does (no tensorboardX).
"""

from typing import Optional

from ..trainer.logger_base import TorchEmLogger
from ..trainer.tensorboard_logger import _select_2d, make_grid, tensorboard_writer

__all__ = ["SelfTrainingTensorboardLogger"]


class SelfTrainingTensorboardLogger(TorchEmLogger):
    """Scalars every step and image panels every ``log_image_interval`` steps."""

    def __init__(self, trainer, save_root: Optional[str], **kwargs):
        super().__init__(trainer, save_root)
        self.log_dir, self.tb = tensorboard_writer(trainer, save_root)
        self.log_image_interval = trainer.log_image_interval

    def flush(self):
        self.tb.flush()

    def _log_images(self, step, name, x, y, prediction, pseudo_labels=None, label_filter=None):
        images = [_select_2d(x)] + [_select_2d(im)[:1] for im in (y, prediction, pseudo_labels, label_filter)
                                    if im is not None]
        self.tb.add_image(tag=f"{name}/overview", img_tensor=make_grid(images), global_step=step)

    def log_combined_loss(self, step, loss):
        self.tb.add_scalar(tag="train/combined_loss", scalar_value=float(loss), global_step=step)

    def log_lr(self, step, lr):
        self.tb.add_scalar(tag="train/learning_rate", scalar_value=float(lr), global_step=step)

    def log_ct(self, step, ct):
        self.tb.add_scalar(tag="train/confidence_threshold", scalar_value=float(ct), global_step=step)

    def log_train_supervised(self, step, loss, x, y, prediction):
        self.tb.add_scalar(tag="train/supervised/loss", scalar_value=float(loss), global_step=step)
        if step % self.log_image_interval == 0:
            self._log_images(step, "train/supervised", x, y, prediction)

    def log_train_unsupervised(self, step, loss, x1, x2, prediction, pseudo_labels=None, label_filter=None):
        self.tb.add_scalar(tag="train/unsupervised/loss", scalar_value=float(loss), global_step=step)
        if step % self.log_image_interval == 0:
            self._log_images(step, "train/unsupervised", x1, None, prediction, pseudo_labels, label_filter)

    def log_validation_supervised(self, step, metric, loss, x, y, prediction):
        self.tb.add_scalar(tag="validation/supervised/loss", scalar_value=float(loss), global_step=step)
        self.tb.add_scalar(tag="validation/supervised/metric", scalar_value=float(metric), global_step=step)
        self._log_images(step, "validation/supervised", x, y, prediction)

    def log_validation_unsupervised(self, step, metric, loss, x1, x2, prediction,
                                    pseudo_labels=None, label_filter=None):
        self.tb.add_scalar(tag="validation/unsupervised/loss", scalar_value=float(loss), global_step=step)
        self.tb.add_scalar(tag="validation/unsupervised/metric", scalar_value=float(metric), global_step=step)
        self._log_images(step, "validation/unsupervised", x1, None, prediction, pseudo_labels, label_filter)

    # the base interface, for a trainer that logs as DefaultTrainer does
    def log_train(self, step, loss, lr, x, y, prediction, log_gradients=False):
        self.log_train_supervised(step, loss, x, y, prediction)
        self.log_lr(step, lr)

    def log_validation(self, step, metric, loss, x, y, prediction):
        self.log_validation_supervised(step, metric, loss, x, y, prediction)
