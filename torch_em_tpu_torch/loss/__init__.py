from .dice import (
    BCEDiceLoss, BCEDiceLossWithLogits, DiceLoss, DiceLossWithLogits, dice_score, flatten_samples,
)
from .wrapper import ApplyAndRemoveMask, ApplyMask, LossWrapper, MaskIgnoreLabel

__all__ = [
    "BCEDiceLoss", "BCEDiceLossWithLogits", "DiceLoss", "DiceLossWithLogits", "dice_score",
    "flatten_samples", "ApplyAndRemoveMask", "ApplyMask", "LossWrapper", "MaskIgnoreLabel",
]
