"""Logger plugin interface, counterpart of ``torch_em_tpu/trainer/logger_base.py``.

The trainer calls ``log_train`` for training steps and ``log_validation``
after each validation, and ``flush`` after each batch of buffered calls,
each validation and the end of ``fit``. The port's loggers are
``TensorboardLogger`` (event files written by the port itself, the trainers'
default as in the JAX package) and ``WandbLogger`` (wandb, imported when it is
constructed).
"""


class TorchEmLogger:
    """Base logger: ``log_train`` / ``log_validation`` hooks called by the trainer."""

    def __init__(self, trainer, save_root: str, **kwargs):
        self.trainer = trainer
        self.save_root = save_root

    def log_train(self, step, loss, lr, x, y, prediction, log_gradients=False):
        raise NotImplementedError

    def log_validation(self, step, metric, loss, x, y, prediction):
        raise NotImplementedError

    def flush(self):
        """Write out what the logger holds; a logger that keeps nothing need not override it."""
