from .affinity_side_loss import AffinitySideLoss
from .cldice import CombinedclDiceLoss, SoftclDiceLoss, SoftSkeletonize, cldice_score
from .combined_loss import CombinedLoss
from .contrastive import ContrastiveLoss
from .dice import (
    BCEDiceLoss, BCEDiceLossWithLogits, DiceLoss, DiceLossWithLogits, dice_score, flatten_samples,
)
from .distance_based import DiceBasedDistanceLoss, DistanceLoss
from .spoco_loss import (
    CombinedAuxLoss, ContrastiveLossBase, ExtendedContrastiveLoss, GaussianKernel, SPOCOConsistencyLoss, SPOCOLoss,
)
from .wrapper import ApplyAndRemoveMask, ApplyMask, LossWrapper, MaskIgnoreLabel

__all__ = [
    "BCEDiceLoss", "BCEDiceLossWithLogits", "DiceLoss", "DiceLossWithLogits", "dice_score",
    "flatten_samples", "ApplyAndRemoveMask", "ApplyMask", "LossWrapper", "MaskIgnoreLabel",
    "AffinitySideLoss", "SoftSkeletonize", "cldice_score", "SoftclDiceLoss", "CombinedclDiceLoss",
    "CombinedLoss", "DistanceLoss", "DiceBasedDistanceLoss", "ContrastiveLoss", "CombinedAuxLoss",
    "ContrastiveLossBase", "ExtendedContrastiveLoss", "GaussianKernel", "SPOCOConsistencyLoss", "SPOCOLoss",
    "EMBEDDING_LOSSES",
]

EMBEDDING_LOSSES = (ContrastiveLoss, ExtendedContrastiveLoss, SPOCOLoss)
"""Losses on pixel embeddings (the tensorboard logger shows their predictions' PCA)."""
