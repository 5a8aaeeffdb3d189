"""Trainer for the Probabilistic U-Net.

Counterpart of ``torch_em_tpu/self_training/probabilistic_unet_trainer.py``
(torch-em's ``self_training/probabilistic_unet_trainer.py``):

- each step maximises the ELBO: ``loss(elbo_fn, x, y)`` with ``elbo_fn(x, y)
  = model.elbo(x, y)``, its posterior noise drawn from the trainer's
  ``generator``;
- ``clipping_value`` becomes the optimizer spec's global-norm clip, as the
  JAX package realises the reference's clip of the posterior's gradients;
- validation takes ``loss_and_metric(elbo_fn, x, y, sample_fn=...)``: the
  metric on the mean of prior samples. The batch is encoded once, and the
  ELBO and every sample reuse that encoding (the JAX step's compiler merges
  the repeated encodings; eager torch would run the U-Net once per sample);
- a logger gets a sigmoid prior sample of the last validation batch.

As in the JAX package, the steps compute in the model's own dtype
(``mixed_precision`` does not apply) and skip a ``device_label_transform``.
"""

import functools
from typing import Optional

import numpy as np
import torch

from ..trainer.default_trainer import DefaultTrainer
from ..trainer.optimizers import OptimizerSpec
from .mean_teacher import Dummy

__all__ = ["ProbabilisticUNetTrainer", "DummyLoss"]

DummyLoss = Dummy


class ProbabilisticUNetTrainer(DefaultTrainer):
    """ELBO training of a ``ProbabilisticUNet`` (arXiv:1806.05034).

    Args:
        clipping_value: Global-norm gradient clip (when the optimizer spec has none).
        prior_samples: Recorded for the reference's API; ``loss_and_metric`` sets the number drawn.
        loss: ``loss(elbo_fn, x, y, generator=...)``, e.g. ``ProbabilisticUNetLoss``.
        loss_and_metric: ``loss_and_metric(elbo_fn, x, y, generator=..., sample_fn=...)``.
        kwargs: The ``DefaultTrainer``'s arguments.
    """

    def __init__(self, clipping_value: Optional[float] = None, prior_samples: int = 16, loss=None,
                 loss_and_metric=None, **kwargs):
        kwargs.pop("metric", None)
        if loss is None or loss_and_metric is None:
            raise ValueError("ProbabilisticUNetTrainer needs a loss and a loss_and_metric.")
        super().__init__(loss=loss, metric=Dummy(), **kwargs)
        self.loss_and_metric = loss_and_metric
        self.clipping_value = clipping_value
        self.prior_samples = prior_samples
        del self._explicit_init_kwargs["metric"]
        self._explicit_init_kwargs.update(clipping_value=clipping_value, prior_samples=prior_samples,
                                          loss_and_metric=loss_and_metric)

    def _build_optimizer(self):
        spec = self.optimizer or OptimizerSpec("adamw", lr=1e-4)
        if self.clipping_value is not None and spec.grad_clip is None:
            spec = OptimizerSpec(spec.name, lr=spec.lr, grad_clip=self.clipping_value, **spec.kwargs)
        self.optimizer = spec
        super()._build_optimizer()

    def _elbo_fn(self, generator, encoded=None):
        return lambda inp, labels: self.model.elbo(inp, labels, generator=generator, encoded=encoded)

    def _train_step(self, x, y):
        self.torch_optimizer.zero_grad(set_to_none=True)
        loss = self.loss(self._elbo_fn(self.generator), x, y, generator=self.generator)
        loss.backward()
        self.optimizer.clip_gradients(self.model.parameters())
        self.torch_optimizer.step()
        return loss.detach(), None

    @torch.no_grad()
    def _validate(self):
        self.model.eval()
        losses, metrics, last = [], [], None
        for x, y in self.val_loader:
            x, y = self._to_device(x), self._to_device(y)
            encoded = self.model.encode(x, y)
            loss, metric = self.loss_and_metric(
                self._elbo_fn(self.generator, encoded), x, y, generator=self.generator,
                sample_fn=functools.partial(self.model.sample, encoded=encoded))
            losses.append(float(loss))
            metrics.append(float(metric))
            last = (x, y, encoded)
        metric_val, loss_val = float(np.mean(metrics)), float(np.mean(losses))
        if self.logger is not None and last is not None:
            x, y, encoded = last
            sample = self.model.sample(x, generator=self.generator, encoded=encoded)
            self.logger.log_validation(self._iteration, metric_val, loss_val, x, y, torch.sigmoid(sample))
        return metric_val
