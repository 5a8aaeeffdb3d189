"""SPOCO trainer: two networks, the second a moving average of the first.

Counterpart of ``torch_em_tpu/trainer/spoco_trainer.py`` (torch-em's
``trainer/spoco_trainer.py``):

- ``model2`` is a frozen deep copy of the model, made when training starts.
  Its forward runs without gradient and in eval mode, as the JAX package
  applies it with ``train=False``, and under the same compute precision as
  the model's;
- the loss is called as ``loss((pred, pred2), y)``, with the trainer's
  ``generator`` where the loss draws random numbers (``needs_rng``);
- after each optimizer step, ``model2`` takes the moving average of the
  model (``ema.MovingAverage``: every parameter and floating buffer, as the
  JAX package's ``tree_map`` over all variables);
- an optional semi-supervised pass after each epoch's training steps
  (``semisupervised_loss(pred, pred2)`` over ``semisupervised_loader``);
- checkpoints carry ``model2_state``, which ``load_checkpoint`` and
  ``from_checkpoint`` restore.

With ``mixed_precision`` both models compute in bfloat16 and return float32,
as the JAX package's U-Net casts its output to float32: the loss sees
float32 predictions. A ``device_label_transform`` is applied to the labels
in the step (the JAX package's SPOCO steps skip it).
"""

import copy
from typing import Optional

import torch

from .default_trainer import DefaultTrainer
from .ema import MovingAverage
from .tensorboard_logger import TensorboardLogger

__all__ = ["SPOCOTrainer"]


class SPOCOTrainer(DefaultTrainer):
    """Trainer for a SPOCO model (arXiv:2103.14572).

    Args:
        model: The model to train.
        momentum: Weight of ``model2``'s own state in its moving average.
        semisupervised_loss: Loss of (pred, pred2) for unlabeled batches.
        semisupervised_loader: Loader of unlabeled batches (given with the loss).
        logger: The logger class; ``TensorboardLogger`` by default, as in the JAX package.
        kwargs: The ``DefaultTrainer``'s arguments.
    """

    def __init__(self, model=None, momentum: float = 0.999, semisupervised_loss=None,
                 semisupervised_loader=None, logger=TensorboardLogger, **kwargs):
        super().__init__(model=model, logger=logger, **kwargs)
        self.momentum = momentum
        assert (semisupervised_loss is None) == (semisupervised_loader is None)
        self.semisupervised_loader = semisupervised_loader
        self.semisupervised_loss = semisupervised_loss
        self.model2: Optional[torch.nn.Module] = None
        self._ema: Optional[MovingAverage] = None
        self._explicit_init_kwargs.update(
            momentum=momentum, semisupervised_loss=semisupervised_loss,
            semisupervised_loader=semisupervised_loader)

    def _compute_models(self):
        return [self.model] if self.model2 is None else [self.model, self.model2]

    def _ensure_model2(self):
        if self.model2 is None:
            self.model2 = copy.deepcopy(self.model).to(self.device).requires_grad_(False).eval()
            self._ema = None

    def _initialize(self, iterations, load_from_checkpoint, epochs=None):
        best_metric = super()._initialize(iterations, load_from_checkpoint, epochs)
        self._ensure_model2()
        return best_metric

    def ema_update(self):
        """model2 <- model2 * momentum + model * (1 - momentum), on the device."""
        if self._ema is None:
            self._ema = MovingAverage(self.model2, self.model)
        self._ema.update(self.momentum)

    def _forward_both(self, x):
        with self._compute_precision():
            with torch.no_grad():
                pred2 = self.model2(x)
            pred = self.model(x)
        return pred, pred2

    def _optimizer_step(self, loss):
        loss.backward()
        self.optimizer.clip_gradients(self.model.parameters())
        self.torch_optimizer.step()
        self.ema_update()

    def _train_step(self, x, y):
        self.torch_optimizer.zero_grad(set_to_none=True)
        if self.device_label_transform is not None:
            y = self.device_label_transform(y)
        pred, pred2 = self._forward_both(x)
        loss = self._loss_value(self.loss, (pred, pred2), y, self.generator)
        self._optimizer_step(loss)
        return loss.detach(), pred.detach()

    def _semisupervised_step(self, x):
        self.torch_optimizer.zero_grad(set_to_none=True)
        pred, pred2 = self._forward_both(x)
        loss = self._loss_value(self.semisupervised_loss, pred, pred2, self.generator)
        self._optimizer_step(loss)
        return loss.detach()

    @torch.no_grad()
    def _val_step(self, x, y):
        if self.device_label_transform is not None:
            y = self.device_label_transform(y)
        with self._compute_precision():
            pred = self.model(x)
            pred2 = self.model2(x)
        loss = self._loss_value(self.loss, (pred, pred2), y)
        if self.metric is not None and not getattr(self.metric, "host_metric", False):
            metric = self.metric(pred, y)
        else:
            metric = loss
        return loss, metric, pred

    def _train_epoch(self, progress=None, profile_dir=None, log_mfu=False):
        t_per_iter = super()._train_epoch(progress, profile_dir=profile_dir, log_mfu=log_mfu)
        if self.semisupervised_loader is not None:
            for x in self.semisupervised_loader:
                self._semisupervised_step(self._to_device(x))
        return t_per_iter

    def save_checkpoint(self, name, current_metric, best_metric, train_time=0.0, **extra_save_dict):
        super().save_checkpoint(name, current_metric, best_metric, train_time=train_time,
                                model2_state=self.model2.state_dict(), **extra_save_dict)

    def load_checkpoint(self, checkpoint="best"):
        save_dict = super().load_checkpoint(checkpoint)
        if "model2_state" in save_dict:
            self._ensure_model2()
            self.model2.load_state_dict(save_dict["model2_state"])
        return save_dict
