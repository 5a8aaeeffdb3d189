"""Data path: datasets, samplers and the loader."""

from .base import Dataset
from .concat_dataset import ConcatDataset
from .dataset_wrapper import DatasetWrapper
from .image_collection_dataset import ImageCollectionDataset
from .loader import DataLoader, DistributedIndexSampler, default_collate
from .pseudo_label_dataset import PseudoLabelDataset
from .raw_dataset import RawDataset, RawDatasetWithMasks
from .raw_image_collection_dataset import RawImageCollectionDataset
from .sampler import (
    MinForegroundSampler, MinInstanceSampler, MinIntensitySampler, MinNoToBackgroundBoundarySampler,
    MinSemanticLabelForegroundSampler, MinTwoInstanceSampler,
)
from .segmentation_dataset import SegmentationDataset
from .tensor_dataset import TensorDataset

__all__ = [
    "Dataset", "ConcatDataset", "DatasetWrapper", "ImageCollectionDataset", "DataLoader", "DistributedIndexSampler", "default_collate", "PseudoLabelDataset",
    "RawDataset", "RawDatasetWithMasks", "RawImageCollectionDataset", "SegmentationDataset", "TensorDataset",
    "MinForegroundSampler", "MinInstanceSampler", "MinIntensitySampler", "MinNoToBackgroundBoundarySampler",
    "MinSemanticLabelForegroundSampler", "MinTwoInstanceSampler",
]
