"""Logger plugin interface, counterpart of ``torch_em_tpu/trainer/logger_base.py``.

The trainer calls ``log_train`` for training steps and ``log_validation``
after each validation. The port's loggers are ``TensorboardLogger``
(tensorboardX) and ``WandbLogger`` (wandb); each imports its package when it
is constructed, since the machine with the card has neither, so
``DefaultTrainer``'s ``logger`` defaults to ``None``.
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
