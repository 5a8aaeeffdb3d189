"""Self-training and domain adaptation: MeanTeacher, FixMatch, UniMatch v2 and the Probabilistic U-Net."""

from .fix_match import FixMatchTrainer, FixMatchTrainerWithInvertibleAugmentations
from .logger import SelfTrainingTensorboardLogger
from .loss import (
    DefaultSelfTrainingLoss, DefaultSelfTrainingLossAndMetric, ProbabilisticUNetLoss,
    ProbabilisticUNetLossAndMetric,
)
from .mean_teacher import Dummy, MeanTeacherTrainer, MeanTeacherTrainerWithInvertibleAugmentations
from .probabilistic_unet_trainer import DummyLoss, ProbabilisticUNetTrainer
from .pseudo_labeling import DefaultPseudoLabeler, ProbabilisticPseudoLabeler, ScheduledPseudoLabeler
from .uni_match_v2 import DefaultUnimatchLoss, DefaultUnimatchLossAndMetric, UniMatchv2Trainer

# augmentation bundles for consistency training
from ..transforms.invertible_augmentations import FixMatchAugmenters, MeanTeacherAugmenters, UniMatchv2Augmenters

__all__ = [
    "FixMatchTrainer", "FixMatchTrainerWithInvertibleAugmentations", "SelfTrainingTensorboardLogger",
    "DefaultSelfTrainingLoss", "DefaultSelfTrainingLossAndMetric", "ProbabilisticUNetLoss",
    "ProbabilisticUNetLossAndMetric", "Dummy", "MeanTeacherTrainer", "MeanTeacherTrainerWithInvertibleAugmentations",
    "DummyLoss", "ProbabilisticUNetTrainer", "DefaultPseudoLabeler", "ProbabilisticPseudoLabeler",
    "ScheduledPseudoLabeler", "DefaultUnimatchLoss", "DefaultUnimatchLossAndMetric", "UniMatchv2Trainer",
    "FixMatchAugmenters", "MeanTeacherAugmenters", "UniMatchv2Augmenters",
]
