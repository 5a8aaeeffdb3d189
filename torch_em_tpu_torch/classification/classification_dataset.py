"""The classification dataset, counterpart of ``torch_em_tpu/classification/classification_dataset.py``."""

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from ..data.base import Dataset
from ..ops.host import resize as _resize

__all__ = ["ClassificationDataset"]


class ClassificationDataset(Dataset):
    """(image (C, *spatial) float32, class id int64) pairs: each image normalized, resized
    channel by channel to ``image_shape`` (linear) and augmented, in that order."""

    def __init__(self, data: Sequence, target: Sequence, normalization: Optional[Callable],
                 augmentation: Optional[Callable], image_shape: Optional[Tuple[int, ...]]):
        if len(data) != len(target):
            raise ValueError(f"Length of data and target don't agree: {len(data)} != {len(target)}")
        self.data, self.target = data, target
        self.normalization, self.augmentation, self.image_shape = normalization, augmentation, image_shape
        self.ndim = data[0].ndim - 1
        self.init_kwargs = {"data": data, "target": target, "normalization": normalization,
                            "augmentation": augmentation, "image_shape": image_shape}

    def __len__(self):
        return len(self.data)

    def resize(self, x):
        """@private"""
        return np.concatenate([_resize(channel, self.image_shape, order=1)[None] for channel in x], axis=0)

    def __getitem__(self, index):
        x, y = np.asarray(self.data[index]), self.target[index]
        if self.normalization is not None:
            x = self.normalization(x)
        if self.image_shape is not None:
            x = self.resize(x)
        if self.augmentation is not None:
            shape = x.shape
            x = np.asarray(self.augmentation(x, x)[0]).reshape(shape)
        return x.astype("float32"), np.asarray(y, dtype="int64")
