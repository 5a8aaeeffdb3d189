from .affinity_side_loss import AffinitySideLoss
from .cldice import CombinedclDiceLoss, SoftclDiceLoss, SoftSkeletonize, cldice_score
from .combined_loss import CombinedLoss
from .dice import (
    BCEDiceLoss, BCEDiceLossWithLogits, DiceLoss, DiceLossWithLogits, dice_score, flatten_samples,
)
from .distance_based import DiceBasedDistanceLoss, DistanceLoss
from .wrapper import ApplyAndRemoveMask, ApplyMask, LossWrapper, MaskIgnoreLabel

__all__ = [
    "BCEDiceLoss", "BCEDiceLossWithLogits", "DiceLoss", "DiceLossWithLogits", "dice_score",
    "flatten_samples", "ApplyAndRemoveMask", "ApplyMask", "LossWrapper", "MaskIgnoreLabel",
    "AffinitySideLoss", "SoftSkeletonize", "cldice_score", "SoftclDiceLoss", "CombinedclDiceLoss",
    "CombinedLoss", "DistanceLoss", "DiceBasedDistanceLoss",
]
