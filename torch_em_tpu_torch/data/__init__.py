"""Data path: datasets, samplers and the loader."""

from .base import Dataset
from .loader import DataLoader, default_collate
from .sampler import (
    MinForegroundSampler, MinInstanceSampler, MinIntensitySampler, MinNoToBackgroundBoundarySampler,
    MinSemanticLabelForegroundSampler, MinTwoInstanceSampler,
)
from .segmentation_dataset import SegmentationDataset

__all__ = [
    "Dataset", "DataLoader", "default_collate", "SegmentationDataset", "MinForegroundSampler",
    "MinInstanceSampler", "MinIntensitySampler", "MinNoToBackgroundBoundarySampler",
    "MinSemanticLabelForegroundSampler", "MinTwoInstanceSampler",
]
