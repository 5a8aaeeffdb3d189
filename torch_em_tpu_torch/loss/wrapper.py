"""Loss wrapper and mask transforms.

Counterpart of ``torch_em_tpu/loss/wrapper.py``: ``LossWrapper`` applies a
(prediction, target) transform before the loss; ``ApplyMask`` masks both,
``ApplyAndRemoveMask`` takes the mask from the target's second half of
channels, ``MaskIgnoreLabel`` masks an ignore label. As in the JAX package,
'crop' masking multiplies by the mask instead of indexing with it: the Dice
family's sums then see zeros where torch-em's would see nothing, which gives
the same values, and shapes stay static.
"""

from typing import Callable, Tuple

import torch

__all__ = ["LossWrapper", "ApplyMask", "ApplyAndRemoveMask", "MaskIgnoreLabel"]


class LossWrapper:
    """Wraps a loss with a (prediction, target) transform."""

    def __init__(self, loss: Callable, transform: Callable):
        if not callable(transform):
            raise ValueError("transform has to be callable.")
        self.loss = loss
        self.transform = transform
        self.init_kwargs = {"loss": loss, "transform": transform}

    def apply_transform(self, prediction, target, **kwargs):
        if isinstance(prediction, (list, tuple)):
            if not isinstance(target, (list, tuple)):
                raise ValueError("A list of predictions needs a list of targets.")
            transformed = [self.transform(p, t, **kwargs) for p, t in zip(prediction, target)]
            return [p for p, _ in transformed], [t for _, t in transformed]
        return self.transform(prediction, target, **kwargs)

    def __call__(self, prediction, target, **kwargs):
        prediction, target = self.apply_transform(prediction, target, **kwargs)
        if isinstance(prediction, (list, tuple)):
            return sum(self.loss(p, t) for p, t in zip(prediction, target))
        return self.loss(prediction, target)


def _multiply(prediction, target, mask, channel_dim):
    mask = mask.to(prediction.dtype)
    return prediction * mask, target * mask


class ApplyMask:
    """Mask prediction and target before the loss ('crop' and 'multiply' both multiply)."""

    MASKING_FUNCS = {"crop": _multiply, "multiply": _multiply}

    def __init__(self, masking_method: str = "crop", channel_dim: int = 1):
        if masking_method not in self.MASKING_FUNCS:
            raise ValueError(
                f"{masking_method} is not available, please use one of {list(self.MASKING_FUNCS)}."
            )
        self.masking_func = self.MASKING_FUNCS[masking_method]
        self.channel_dim = channel_dim
        self.init_kwargs = {"masking_method": masking_method, "channel_dim": channel_dim}

    def __call__(self, prediction, target, mask) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.masking_func(prediction, target, mask, self.channel_dim)


class ApplyAndRemoveMask(ApplyMask):
    """Take the mask from the target's extra channels (target.C == 2 * prediction.C)."""

    def __call__(self, prediction, target):
        if target.ndim != prediction.ndim or target.shape[1] != 2 * prediction.shape[1] \
                or target.shape[2:] != prediction.shape[2:]:
            raise ValueError(f"target {tuple(target.shape)} does not carry a mask for "
                             f"prediction {tuple(prediction.shape)}")
        separating_channel = target.shape[1] // 2
        mask = target[:, separating_channel:]
        target = target[:, :separating_channel]
        return super().__call__(prediction, target, mask)


class MaskIgnoreLabel(ApplyMask):
    """Mask an ignore label in the target."""

    def __init__(self, ignore_label: int = -1, masking_method: str = "crop", channel_dim: int = 1):
        super().__init__(masking_method, channel_dim)
        self.ignore_label = ignore_label
        self.init_kwargs["ignore_label"] = ignore_label

    def __call__(self, prediction, target):
        return super().__call__(prediction, target, target != self.ignore_label)
