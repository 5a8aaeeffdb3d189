"""Default augmentations for self-training (torch-em's ``self_training/augmentations.py``)."""

from ..transforms.invertible_augmentations import FixMatchAugmenters, MeanTeacherAugmenters, UniMatchv2Augmenters
from ..transforms.raw import get_default_mean_teacher_augmentations

__all__ = [
    "get_default_mean_teacher_augmentations", "MeanTeacherAugmenters",
    "FixMatchAugmenters", "UniMatchv2Augmenters",
]
