"""Pseudo-label dataset: raw patches with labels predicted on the fly.

The port's own copy of ``torch_em_tpu/data/pseudo_label_dataset.py``
(torch-em's ``data/pseudo_label_dataset.py``). The pseudo-labeler is a
callable on a batched CPU tensor (1, C, *spatial), e.g. a model with its
activation; it may compute on its own device and return a tensor there or
a numpy array. Augmentations (``transform``) apply to the raw patch before
the labels are predicted; ``raw_transform`` applies after, to the raw alone.
"""

import os
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.tensor import ensure_array_with_channels
from .raw_dataset import RawDataset

__all__ = ["PseudoLabelDataset"]


class PseudoLabelDataset(RawDataset):
    """``RawDataset`` whose samples are (raw, labels predicted by ``pseudo_labeler``)."""

    def __init__(
        self,
        raw_path: Union[List[Any], str, os.PathLike],
        raw_key: Optional[str],
        patch_shape: Tuple[int, ...],
        pseudo_labeler: Callable,
        raw_transform: Optional[Callable] = None,
        label_transform: Optional[Callable] = None,
        transform: Optional[Callable] = None,
        roi: Optional[Union[slice, Tuple[slice, ...]]] = None,
        dtype="float32",
        n_samples: Optional[int] = None,
        sampler: Optional[Callable] = None,
        ndim: Optional[int] = None,
        with_channels: bool = False,
    ):
        super().__init__(
            raw_path, raw_key, patch_shape, raw_transform=raw_transform, transform=transform, roi=roi,
            dtype=dtype, n_samples=n_samples, sampler=sampler, ndim=ndim, with_channels=with_channels,
        )
        self.pseudo_labeler = pseudo_labeler
        self.label_transform = label_transform
        self.init_kwargs.update({"pseudo_labeler": pseudo_labeler, "label_transform": label_transform})
        del self.init_kwargs["augmentations"]

    def __getitem__(self, index):
        raw = self._get_sample(index)
        # augmentations apply to the raw only; the labels are predicted from the result
        if self.transform is not None:
            raw = self.transform(raw)
            if isinstance(raw, (list, tuple)):
                raw = raw[0]
        raw = ensure_array_with_channels(raw, ndim=self._ndim, dtype=self.dtype)
        with torch.no_grad():
            labels = self.pseudo_labeler(torch.from_numpy(np.ascontiguousarray(raw[None])))
        labels = (labels.detach().cpu().numpy() if isinstance(labels, torch.Tensor) else np.asarray(labels))[0]

        if self.raw_transform is not None:
            raw = self.raw_transform(raw)
        raw = ensure_array_with_channels(raw, ndim=self._ndim, dtype=self.dtype)
        if self.label_transform is not None:
            labels = self.label_transform(labels)
        labels = ensure_array_with_channels(labels, ndim=self._ndim, dtype="float32")
        return raw, labels
