"""Dice losses, the default loss and metric of the trainer.

Counterpart of ``torch_em_tpu/loss/dice.py`` (itself torch-em's
``loss/dice.py``): ``flatten_samples`` flattens channel-first,
``dice_score`` is ``2 * (x.y) / max(x.x + y.y, eps)`` per channel with
``reduce_channel`` in {sum, mean, max, min, None}, and the losses are
``1 - dice`` alone or beside a binary cross entropy. The losses are plain
callables of (prediction, target) on torch tensors and carry
``init_kwargs``, so a trainer checkpoint can rebuild them.

The JAX package's ``shard_parts``/``loss_from_parts`` (the statistics that a
spatially sharded step sums across devices) wait for the port of
``parallel/``.
"""

from typing import Optional

import torch

__all__ = [
    "flatten_samples", "dice_score", "DiceLoss", "DiceLossWithLogits",
    "BCEDiceLoss", "BCEDiceLossWithLogits",
]

_REDUCTIONS = {
    "sum": torch.sum, "mean": torch.mean, "max": torch.amax, "min": torch.amin,
}


def flatten_samples(input_: torch.Tensor) -> torch.Tensor:
    """Flatten (N, C, *spatial) to (C, N * prod(spatial)), channel axis first."""
    return input_.transpose(0, 1).reshape(input_.shape[1], -1)


def dice_score(
    input_: torch.Tensor,
    target: torch.Tensor,
    invert: bool = False,
    channelwise: bool = True,
    reduce_channel: Optional[str] = "sum",
    eps: float = 1e-7,
) -> torch.Tensor:
    """Dice score between input and target; ``invert`` gives ``1 - score``."""
    if input_.shape != target.shape:
        raise ValueError(f"Expect input and target of same shape, got: {input_.shape}, {target.shape}.")

    if channelwise:
        input_ = flatten_samples(input_)
        target = flatten_samples(target)
        numerator = (input_ * target).sum(dim=-1)
        denominator = (input_ * input_).sum(dim=-1) + (target * target).sum(dim=-1)
        channelwise_score = 2 * (numerator / denominator.clamp(min=eps))
        if invert:
            channelwise_score = 1.0 - channelwise_score
        if reduce_channel is None:
            return channelwise_score
        if reduce_channel not in _REDUCTIONS:
            raise ValueError(f"Unsupported channel reduction {reduce_channel}")
        return _REDUCTIONS[reduce_channel](channelwise_score)

    numerator = (input_ * target).sum()
    denominator = (input_ * input_).sum() + (target * target).sum()
    score = 2.0 * (numerator / denominator.clamp(min=eps))
    if invert:
        score = 1.0 - score
    return score


def _bce(pred, target, eps=1e-7):
    pred = pred.clamp(eps, 1.0 - eps)
    return -(target * torch.log(pred) + (1.0 - target) * torch.log(1.0 - pred)).mean()


def _bce_with_logits(logits, target):
    return (logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))).mean()


class DiceLoss:
    """Dice error between binary input and target."""

    def __init__(self, channelwise: bool = True, eps: float = 1e-7, reduce_channel: Optional[str] = "sum"):
        if reduce_channel not in ("sum", "mean", "max", "min", None):
            raise ValueError(f"Unsupported channel reduction {reduce_channel}")
        self.channelwise = channelwise
        self.eps = eps
        self.reduce_channel = reduce_channel
        self.init_kwargs = {"channelwise": channelwise, "eps": eps, "reduce_channel": reduce_channel}

    def __call__(self, input_: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return dice_score(
            input_, target, invert=True, channelwise=self.channelwise,
            reduce_channel=self.reduce_channel, eps=self.eps,
        )


class DiceLossWithLogits(DiceLoss):
    """Dice error on sigmoided logits."""

    def __call__(self, input_: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return super().__call__(torch.sigmoid(input_), target)


class BCEDiceLoss:
    """alpha * Dice + beta * BCE."""

    def __init__(self, alpha: float = 1.0, beta: float = 1.0, channelwise: bool = True, eps: float = 1e-7):
        self.alpha = alpha
        self.beta = beta
        self.channelwise = channelwise
        self.eps = eps
        self.init_kwargs = {"alpha": alpha, "beta": beta, "channelwise": channelwise, "eps": eps}

    def __call__(self, input_: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        loss_dice = dice_score(input_, target, invert=True, channelwise=self.channelwise, eps=self.eps)
        return self.alpha * loss_dice + self.beta * _bce(input_, target)


class BCEDiceLossWithLogits(BCEDiceLoss):
    """alpha * Dice-on-sigmoid + beta * BCE-with-logits."""

    def __call__(self, input_: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        loss_dice = dice_score(
            torch.sigmoid(input_), target, invert=True, channelwise=self.channelwise, eps=self.eps
        )
        return self.alpha * loss_dice + self.beta * _bce_with_logits(input_, target)
