"""Lazy patch-sampling dataset over numpy volumes.

Counterpart of ``torch_em_tpu/data/segmentation_dataset.py`` (after torch-em's
``data/segmentation_dataset.py``), with the same sampling semantics: uniform
random bounding boxes drawn from the global ``np.random`` (so the same
``np.random.seed`` gives the same crops as the JAX package), rejection
sampling with a cap of 500 attempts, ``pre_label_transform`` before the
sampler's check, padding up to the patch shape, squeezing the singleton axis
of 2D patches cut from 3D data, the raw / label / joint / label2 transform
order, ``with_channels``, ROI views and ``z_ext``.

Data comes through ``utils.io.load_data``: numpy arrays and ``.npy`` files
for now. A sample is a pair of numpy arrays (C, *spatial).
"""

from math import ceil
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np

from ..utils.io import RoiWrapper, load_data
from ..utils.tensor import ensure_array_with_channels, ensure_patch_shape, ensure_spatial_array, validate_roi
from .base import Dataset

__all__ = ["SegmentationDataset"]


def _normalize_roi(roi, shape):
    if isinstance(roi, slice):
        roi = (roi,)
    validate_roi(roi, shape)
    full = tuple(slice(*r.indices(s)) for r, s in zip(roi, shape))
    return full + tuple(slice(0, s) for s in shape[len(full):])


class SegmentationDataset(Dataset):
    """(raw, label) patches sampled at random from a raw and a label volume."""

    max_sampling_attempts = 500

    @staticmethod
    def compute_len(shape, patch_shape):
        if patch_shape is None:
            return 1
        return ceil(np.prod([float(sh / csh) for sh, csh in zip(shape, patch_shape)]))

    def __init__(
        self,
        raw_path: Union[List[Any], str, np.ndarray],
        raw_key: Optional[str],
        label_path: Union[List[Any], str, np.ndarray],
        label_key: Optional[str],
        patch_shape: Tuple[int, ...],
        raw_transform: Optional[Callable] = None,
        label_transform: Optional[Callable] = None,
        label_transform2: Optional[Callable] = None,
        transform: Optional[Callable] = None,
        roi: Optional[Union[slice, Tuple[slice, ...]]] = None,
        dtype="float32",
        label_dtype="float32",
        n_samples: Optional[int] = None,
        sampler: Optional[Callable] = None,
        ndim: Optional[int] = None,
        with_channels: bool = False,
        with_label_channels: bool = False,
        with_padding: bool = True,
        z_ext: Optional[int] = None,
        pre_label_transform: Optional[Callable] = None,
    ):
        self.raw_path = raw_path
        self.raw_key = raw_key
        self.raw = load_data(raw_path, raw_key)

        self.label_path = label_path
        self.label_key = label_key
        self.labels = load_data(label_path, label_key)

        self._with_channels = with_channels
        self._with_label_channels = with_label_channels

        if roi is not None:
            shape = self.raw.shape[1:] if self._with_channels else self.raw.shape
            roi = _normalize_roi(roi, shape)
            self.raw = RoiWrapper(self.raw, (slice(None),) + roi) if self._with_channels \
                else RoiWrapper(self.raw, roi)
            self.labels = RoiWrapper(self.labels, (slice(None),) + roi) if self._with_label_channels \
                else RoiWrapper(self.labels, roi)

        shape_raw = self.raw.shape[1:] if self._with_channels else self.raw.shape
        shape_label = self.labels.shape[1:] if self._with_label_channels else self.labels.shape
        if tuple(shape_raw) != tuple(shape_label):
            raise ValueError(f"raw {tuple(shape_raw)} and labels {tuple(shape_label)} differ in shape")

        self.shape = tuple(shape_raw)
        self.roi = roi

        self._ndim = len(shape_raw) if ndim is None else ndim
        if self._ndim not in (2, 3, 4):
            raise ValueError(f"Invalid data dimensions: {self._ndim}.")
        if patch_shape is not None and len(patch_shape) not in (self._ndim, self._ndim + 1):
            raise ValueError(f"patch_shape {patch_shape} does not fit data of {self._ndim} dimensions")
        self.patch_shape = tuple(patch_shape) if patch_shape is not None else None

        self.raw_transform = raw_transform
        self.label_transform = label_transform
        self.label_transform2 = label_transform2
        self.transform = transform
        self.sampler = sampler
        self.with_padding = with_padding
        self.pre_label_transform = pre_label_transform

        self.dtype = dtype
        self.label_dtype = label_dtype

        self._len = self.compute_len(self.shape, self.patch_shape) if n_samples is None else n_samples
        self.z_ext = z_ext
        self.sample_shape = self.patch_shape

        self.init_kwargs = {
            "raw_path": raw_path, "raw_key": raw_key, "label_path": label_path, "label_key": label_key,
            "patch_shape": patch_shape, "raw_transform": raw_transform, "label_transform": label_transform,
            "label_transform2": label_transform2, "transform": transform, "roi": roi, "dtype": dtype,
            "label_dtype": label_dtype, "n_samples": n_samples, "sampler": sampler, "ndim": ndim,
            "with_channels": with_channels, "with_label_channels": with_label_channels,
            "with_padding": with_padding, "z_ext": z_ext, "pre_label_transform": pre_label_transform,
        }

    def __len__(self):
        return self._len

    @property
    def ndim(self):
        return self._ndim

    def _sample_bounding_box(self):
        if self.sample_shape is None:
            if self.z_ext is None:
                bb_start = [0] * len(self.shape)
                patch_shape_for_bb = self.shape
            else:
                z_diff = self.shape[0] - self.z_ext
                bb_start = [np.random.randint(0, z_diff) if z_diff > 0 else 0] + [0] * len(self.shape[1:])
                patch_shape_for_bb = (self.z_ext, *self.shape[1:])
        else:
            bb_start = [
                np.random.randint(0, sh - psh) if sh - psh > 0 else 0
                for sh, psh in zip(self.shape, self.sample_shape)
            ]
            patch_shape_for_bb = self.sample_shape
        return tuple(slice(start, start + psh) for start, psh in zip(bb_start, patch_shape_for_bb))

    def _get_desired_raw_and_labels(self):
        bb = self._sample_bounding_box()
        bb_raw = (slice(None),) + bb if self._with_channels else bb
        bb_labels = (slice(None),) + bb if self._with_label_channels else bb
        raw, labels = np.asarray(self.raw[bb_raw]), np.asarray(self.labels[bb_labels])
        if self.pre_label_transform is not None:
            labels = self.pre_label_transform(labels)
        return raw, labels

    def _get_sample(self, index):
        raw, labels = self._get_desired_raw_and_labels()

        if self.sampler is not None:
            sample_id = 0
            while not self.sampler(raw, labels):
                raw, labels = self._get_desired_raw_and_labels()
                sample_id += 1
                if sample_id > self.max_sampling_attempts:
                    raise RuntimeError(
                        f"Could not sample a valid batch in {self.max_sampling_attempts} attempts"
                    )

        if self.patch_shape is not None and self.with_padding:
            raw, labels = ensure_patch_shape(
                raw=raw, labels=labels, patch_shape=self.patch_shape,
                have_raw_channels=self._with_channels, have_label_channels=self._with_label_channels,
            )

        # squeeze the singleton spatial axis of 2d patches like (1, H, W)
        if self.patch_shape is not None and len(self.patch_shape) == self._ndim + 1:
            raw = np.squeeze(raw, axis=1 if self._with_channels else 0)
            labels = np.squeeze(labels, axis=1 if self._with_label_channels else 0)

        return raw, labels

    def __getitem__(self, index):
        raw, labels = self._get_sample(index)
        initial_label_dtype = labels.dtype

        if self.raw_transform is not None:
            raw = self.raw_transform(raw)
        if self.label_transform is not None:
            labels = self.label_transform(labels)
        if self.transform is not None:
            raw, labels = self.transform(raw, labels)
        if self.label_transform2 is not None:
            labels = ensure_spatial_array(labels, self.ndim, dtype=initial_label_dtype)
            labels = self.label_transform2(labels)

        raw = ensure_array_with_channels(raw, ndim=self._ndim, dtype=self.dtype)
        labels = ensure_array_with_channels(labels, ndim=self._ndim, dtype=self.label_dtype)
        return raw, labels
