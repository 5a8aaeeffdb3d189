"""Patch-sampling dataset over per-image files (tif, png, jpg, npy).

The port's own copy of ``torch_em_tpu/data/image_collection_dataset.py``
(after torch-em's ``data/image_collection_dataset.py``): 2D patches sampled
from a collection of images with the same rejection sampling, the retry cap
of 50 per image before moving to another one and of 500 in all, and the
channel-position heuristic (a trailing axis shorter than 16 holds the
channels). Bounding boxes are drawn from the global ``np.random``, so the
same seed gives the JAX package's patches.
"""

import os
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from ..utils.io import load_image, supports_memmap
from ..utils.tensor import ensure_array_with_channels, ensure_patch_shape, ensure_spatial_array
from .base import Dataset


class ImageCollectionDataset(Dataset):
    """Dataset providing (raw, label) patches from collections of image files."""

    max_sampling_attempts = 500
    max_sampling_attempts_image = 50

    def _check_inputs(self, raw_images, label_images, full_check):
        if len(raw_images) != len(label_images):
            raise ValueError(
                f"Expect same number of raw and label images, got {len(raw_images)} and {len(label_images)}"
            )
        if not full_check:
            return
        is_multichan = None
        for raw_im, label_im in zip(raw_images, label_images):
            if supports_memmap(raw_im) and supports_memmap(label_im):
                shape = load_image(raw_im).shape
                assert len(shape) in (2, 3)
                multichan = len(shape) == 3
                if is_multichan is None:
                    is_multichan = multichan
                else:
                    assert is_multichan == multichan
                if is_multichan:
                    # channel heuristic: trailing axis < 16 -> channel-last
                    shape = shape[:-1] if shape[-1] < 16 else shape[1:]
                label_shape = load_image(label_im).shape
                if tuple(shape) != tuple(label_shape):
                    raise ValueError(
                        f"Expect raw and labels of same shape, got {shape}, {label_shape} "
                        f"for {raw_im}, {label_im}"
                    )

    def __init__(
        self,
        raw_image_paths: List[Union[str, os.PathLike]],
        label_image_paths: List[Union[str, os.PathLike]],
        patch_shape: Optional[Tuple[int, ...]],
        raw_transform: Optional[Callable] = None,
        label_transform: Optional[Callable] = None,
        label_transform2: Optional[Callable] = None,
        transform: Optional[Callable] = None,
        dtype="float32",
        label_dtype="float32",
        n_samples: Optional[int] = None,
        sampler: Optional[Callable] = None,
        full_check: bool = False,
        with_padding: bool = True,
        pre_label_transform: Optional[Callable] = None,
    ):
        self._check_inputs(raw_image_paths, label_image_paths, full_check=full_check)
        self.raw_images = raw_image_paths
        self.label_images = label_image_paths
        self._ndim = 2

        if patch_shape is not None:
            assert len(patch_shape) == self._ndim
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

        if n_samples is None:
            self._len = len(self.raw_images)
            self.sample_random_index = False
        else:
            self._len = n_samples
            self.sample_random_index = True

        self.init_kwargs = {
            "raw_image_paths": raw_image_paths, "label_image_paths": label_image_paths,
            "patch_shape": patch_shape, "raw_transform": raw_transform, "label_transform": label_transform,
            "label_transform2": label_transform2, "transform": transform, "dtype": dtype,
            "label_dtype": label_dtype, "n_samples": n_samples, "sampler": sampler,
            "full_check": full_check, "with_padding": with_padding, "pre_label_transform": pre_label_transform,
        }

    def __len__(self):
        return self._len

    @property
    def ndim(self):
        return self._ndim

    def _sample_bounding_box(self, shape):
        if self.patch_shape is None:
            patch_shape_for_bb = shape
            bb_start = [0] * len(shape)
        else:
            patch_shape_for_bb = self.patch_shape
            bb_start = [
                np.random.randint(0, sh - psh) if sh - psh > 0 else 0
                for sh, psh in zip(shape, patch_shape_for_bb)
            ]
        return tuple(slice(start, start + psh) for start, psh in zip(bb_start, patch_shape_for_bb))

    def _load_data(self, raw_path, label_path):
        if getattr(self, "have_tensor_data", False):
            raw, label = raw_path, label_path
        else:
            raw = load_image(raw_path, memmap=False)
            label = load_image(label_path, memmap=False)

        have_raw_channels = getattr(self, "with_channels", raw.ndim == 3)
        have_label_channels = getattr(self, "with_label_channels", label.ndim == 3)
        if have_label_channels:
            raise NotImplementedError("Multi-channel labels are not supported.")

        channel_first = None
        if have_raw_channels:
            channel_first = raw.shape[-1] > 16

        if self.patch_shape is not None and self.with_padding:
            raw, label = ensure_patch_shape(
                raw=raw, labels=label, patch_shape=self.patch_shape,
                have_raw_channels=have_raw_channels, have_label_channels=have_label_channels,
                channel_first=channel_first,
            )

        shape = raw.shape
        prefix_box = tuple()
        if have_raw_channels:
            if channel_first:
                shape = shape[1:]
                prefix_box = (slice(None),)
            else:
                shape = shape[:-1]

        return raw, label, shape, prefix_box, have_raw_channels

    def _get_desired_raw_and_labels(self, raw, label, shape, prefix_box):
        bb = self._sample_bounding_box(shape)
        raw_patch = np.array(raw[prefix_box + bb])
        label_patch = np.array(label[bb])
        if self.pre_label_transform is not None:
            label_patch = self.pre_label_transform(label_patch)
        return raw_patch, label_patch

    def _get_sample(self, index):
        if self.sample_random_index:
            index = np.random.randint(0, len(self.raw_images))
        raw_path, label_path = self.raw_images[index], self.label_images[index]
        raw, label, shape, prefix_box, have_raw_channels = self._load_data(raw_path, label_path)
        raw_patch, label_patch = self._get_desired_raw_and_labels(raw, label, shape, prefix_box)

        if self.sampler is not None:
            sample_id = 0
            while not self.sampler(raw_patch, label_patch):
                raw_patch, label_patch = self._get_desired_raw_and_labels(raw, label, shape, prefix_box)
                sample_id += 1
                # rotate to another image to avoid spinning on an empty one
                if sample_id % self.max_sampling_attempts_image == 0:
                    index = np.random.randint(0, len(self.raw_images))
                    raw_path, label_path = self.raw_images[index], self.label_images[index]
                    raw, label, shape, prefix_box, have_raw_channels = self._load_data(raw_path, label_path)
                if sample_id > self.max_sampling_attempts:
                    raise RuntimeError(
                        f"Could not sample a valid batch in {self.max_sampling_attempts} attempts"
                    )

        if have_raw_channels and len(prefix_box) == 0:
            raw_patch = raw_patch.transpose((2, 0, 1))
        return raw_patch, label_patch

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
