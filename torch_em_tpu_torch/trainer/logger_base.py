"""Logger plugin interface, counterpart of ``torch_em_tpu/trainer/logger_base.py``.

The trainer calls ``log_train`` for training steps and ``log_validation``
after each validation. The port has no ``TensorboardLogger`` yet (the
machine with the card has no tensorboard package), so a trainer's
``logger`` defaults to ``None``.
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
