"""Weights & Biases logging, counterpart of ``torch_em_tpu/trainer/wandb_logger.py``.

wandb is imported when the logger is constructed (neither the CPU test
machine nor the one with the card has it); without it the constructor
raises an ``ImportError`` that names the package.
"""

from typing import Optional

from .logger_base import TorchEmLogger
from .tensorboard_logger import _to_numpy

__all__ = ["WandbLogger"]


class WandbLogger(TorchEmLogger):
    """Logs scalars and the input image to a wandb run; names an unnamed trainer after the run."""

    def __init__(self, trainer, save_root: Optional[str], *, project_name: Optional[str] = None,
                 log_model_freq: Optional[int] = None, mode: Optional[str] = None, config=None, **kwargs):
        super().__init__(trainer, save_root)
        try:
            import wandb
        except ImportError as e:
            raise ImportError("The WandbLogger needs the wandb package, which is not installed; "
                              "pass logger=None or another logger.") from e
        self.wandb = wandb
        self.log_image_interval = trainer.log_image_interval
        self.run = wandb.init(project=project_name, name=trainer.name, mode=mode, config=config)
        if trainer.name is None:
            trainer.name = self.run.name
            trainer.id_ = self.run.id

    def get_wandb(self):
        return self.wandb

    def log_train(self, step, loss, lr, x, y, prediction, log_gradients=False):
        self.run.log({"train/loss": float(loss), "train/learning_rate": float(lr)}, step=step)
        if step % self.log_image_interval == 0 and x is not None:
            self.run.log({"train/input": self.wandb.Image(_to_numpy(x)[0, 0])}, step=step)

    def log_validation(self, step, metric, loss, x, y, prediction):
        self.run.log({"validation/loss": float(loss), "validation/metric": float(metric)}, step=step)
