"""Self-training losses.

Counterpart of ``torch_em_tpu/self_training/loss.py`` (torch-em's
``self_training/loss.py``). A loss is called as ``loss(apply_fn, input_,
labels, label_filter=None, generator=None)``, where ``apply_fn`` is the
student's forward (the Probabilistic U-Net losses take its ELBO instead), so
that a trainer can warp the input or draw noise inside it. The filter masks
both the prediction and the labels.
"""

from typing import Callable, Optional, Union

import torch

from ..loss import DiceLoss
from ..models.base import get_activation

__all__ = [
    "DefaultSelfTrainingLoss", "DefaultSelfTrainingLossAndMetric",
    "ProbabilisticUNetLoss", "ProbabilisticUNetLossAndMetric",
]


def _masked(loss, prediction, labels, label_filter):
    if label_filter is None:
        return loss(prediction, labels)
    return loss(prediction * label_filter, labels * label_filter)


class DefaultSelfTrainingLoss:
    """``loss(activation(apply_fn(input_)), pseudo_labels)``, both masked by the filter."""

    def __init__(self, loss: Optional[Callable] = None, activation: Optional[Union[str, Callable]] = None):
        self.activation = get_activation(activation)
        self.loss = DiceLoss() if loss is None else loss
        self.init_kwargs = {"loss": self.loss, "activation": activation}

    def _predict(self, apply_fn, input_):
        prediction = apply_fn(input_)
        return prediction if self.activation is None else self.activation(prediction)

    def __call__(self, apply_fn, input_, labels, label_filter=None, generator=None):
        return _masked(self.loss, self._predict(apply_fn, input_), labels, label_filter)


class DefaultSelfTrainingLossAndMetric(DefaultSelfTrainingLoss):
    """The loss as ``DefaultSelfTrainingLoss`` and the metric on the unmasked prediction."""

    def __init__(self, loss: Optional[Callable] = None, metric: Optional[Callable] = None,
                 activation: Optional[Union[str, Callable]] = None):
        super().__init__(loss, activation)
        self.metric = DiceLoss() if metric is None else metric
        self.init_kwargs = {"loss": self.loss, "metric": self.metric, "activation": activation}

    def __call__(self, apply_fn, input_, labels, label_filter=None, generator=None):
        prediction = self._predict(apply_fn, input_)
        return _masked(self.loss, prediction, labels, label_filter), self.metric(prediction, labels)


class ProbabilisticUNetLoss:
    """The negative ELBO (or ``loss(elbo)``); ``apply_fn(input_, labels)`` returns the ELBO."""

    def __init__(self, loss: Optional[Callable] = None):
        self.loss = loss
        self.init_kwargs = {"loss": loss}

    def __call__(self, apply_fn, input_, labels, label_filter=None, generator=None):
        elbo = apply_fn(input_, labels)
        return -elbo if self.loss is None else self.loss(elbo)


class ProbabilisticUNetLossAndMetric:
    """The negative ELBO and, given ``sample_fn(input_, generator)``, a metric on the mean of
    ``prior_samples`` activated prior samples (else the loss twice)."""

    def __init__(self, loss: Optional[Callable] = None, metric: Optional[Callable] = None,
                 activation: Optional[Union[str, Callable]] = None, prior_samples: int = 16):
        self.loss = loss
        self.metric = DiceLoss() if metric is None else metric
        self.activation = get_activation(activation)
        self.prior_samples = prior_samples
        self.init_kwargs = {"loss": loss, "metric": self.metric, "activation": activation,
                            "prior_samples": prior_samples}

    def __call__(self, apply_fn, input_, labels, label_filter=None, generator=None, sample_fn=None):
        elbo = apply_fn(input_, labels)
        loss = -elbo if self.loss is None else self.loss(elbo)
        if sample_fn is None:
            return loss, loss
        samples = torch.stack([sample_fn(input_, generator) for _ in range(self.prior_samples)])
        if self.activation is not None:
            samples = self.activation(samples)
        return loss, self.metric(samples.mean(dim=0), labels)
