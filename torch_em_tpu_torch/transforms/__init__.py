from .label import (
    AffinityTransform, BoundaryTransform, BoundaryTransformWithIgnoreLabel, DistanceTransform,
    MinSizeLabelTransform, NoToBackgroundBoundaryTransform, OneHotTransform, PerObjectDistanceTransform,
    connected_components, label_consecutive, labels_to_binary,
)
from .raw import standardize

__all__ = [
    "standardize", "connected_components", "labels_to_binary", "label_consecutive",
    "MinSizeLabelTransform", "BoundaryTransform", "NoToBackgroundBoundaryTransform",
    "BoundaryTransformWithIgnoreLabel", "AffinityTransform", "OneHotTransform", "DistanceTransform",
    "PerObjectDistanceTransform",
]
