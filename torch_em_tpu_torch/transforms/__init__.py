"""Transforms: raw (intensity), label targets, geometric augmentations, generic."""

from .augmentation import (
    AUGMENTATIONS, AugmentationPipeline, KorniaAugmentationPipeline, RandomElasticDeformation,
    RandomElasticDeformation3D, get_augmentations,
)
from .generic import Compose, PadIfNecessary, Rescale, ResizeInputs, ResizeLongestSideInputs, Tile
from .label import (
    AffinityTransform, BoundaryTransform, BoundaryTransformWithIgnoreLabel, DistanceTransform,
    MinSizeLabelTransform, NoToBackgroundBoundaryTransform, OneHotTransform, PerObjectDistanceTransform,
    connected_components, label_consecutive, labels_to_binary,
)
from .raw import (
    AdditiveGaussianNoise, AdditivePoissonNoise, GaussianBlur, PoissonNoise, RandomContrast, RawTransform,
    get_default_mean_teacher_augmentations, get_raw_transform, normalize, normalize_percentile, standardize,
)

__all__ = [
    "standardize", "normalize", "normalize_percentile", "RandomContrast", "AdditiveGaussianNoise",
    "AdditivePoissonNoise", "PoissonNoise", "GaussianBlur", "RawTransform", "get_raw_transform",
    "get_default_mean_teacher_augmentations", "connected_components", "labels_to_binary",
    "label_consecutive", "MinSizeLabelTransform", "BoundaryTransform", "NoToBackgroundBoundaryTransform",
    "BoundaryTransformWithIgnoreLabel", "AffinityTransform", "OneHotTransform", "DistanceTransform",
    "PerObjectDistanceTransform", "get_augmentations", "AugmentationPipeline", "KorniaAugmentationPipeline",
    "RandomElasticDeformation", "RandomElasticDeformation3D", "AUGMENTATIONS", "Tile", "Compose", "Rescale",
    "ResizeInputs", "ResizeLongestSideInputs", "PadIfNecessary",
]
