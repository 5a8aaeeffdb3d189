"""Raw-only patch dataset over image files: the port's own copy of
``torch_em_tpu/data/raw_image_collection_dataset.py`` (after torch-em's
``data/raw_image_collection_dataset.py``), with the same two-view
augmentations and channel heuristic."""

import os
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np

from ..utils.io import load_image, supports_memmap
from ..utils.tensor import ensure_array_with_channels
from .base import Dataset


class RawImageCollectionDataset(Dataset):
    max_sampling_attempts = 500

    def _check_inputs(self, raw_images, full_check):
        if not full_check:
            return
        for raw_im in raw_images:
            if supports_memmap(raw_im):
                shape = load_image(raw_im).shape
                assert len(shape) in (2, 3)

    def __init__(
        self,
        raw_image_paths: Union[List[Any], str, os.PathLike],
        patch_shape: Tuple[int, ...],
        raw_transform: Optional[Callable] = None,
        transform: Optional[Callable] = None,
        dtype="float32",
        n_samples: Optional[int] = None,
        sampler: Optional[Callable] = None,
        augmentations: Optional[Tuple[Callable, Callable]] = None,
        full_check: bool = False,
    ):
        self._check_inputs(raw_image_paths, full_check)
        self.raw_images = raw_image_paths
        self._ndim = 2

        assert len(patch_shape) == self._ndim
        self.patch_shape = tuple(patch_shape)

        self.raw_transform = raw_transform
        self.transform = transform
        self.dtype = dtype
        self.sampler = sampler

        if n_samples is None:
            self._len = len(self.raw_images)
            self.sample_random_index = False
        else:
            self._len = n_samples
            self.sample_random_index = True

        if augmentations is not None:
            assert len(augmentations) == 2
        self.augmentations = augmentations

        self.init_kwargs = {
            "raw_image_paths": raw_image_paths, "patch_shape": patch_shape, "raw_transform": raw_transform,
            "transform": transform, "dtype": dtype, "n_samples": n_samples, "sampler": sampler,
            "augmentations": augmentations, "full_check": full_check,
        }

    def __len__(self):
        return self._len

    @property
    def ndim(self):
        return self._ndim

    def _sample_bounding_box(self, shape):
        bb_start = [
            np.random.randint(0, sh - psh) if sh - psh > 0 else 0
            for sh, psh in zip(shape, self.patch_shape)
        ]
        return tuple(slice(start, start + psh) for start, psh in zip(bb_start, self.patch_shape))

    def _ensure_patch_shape(self, raw, have_raw_channels, channel_first):
        shape = raw.shape
        if have_raw_channels and channel_first:
            shape = shape[1:]
        if any(sh < psh for sh, psh in zip(shape, self.patch_shape)):
            pw = [(0, max(0, psh - sh)) for sh, psh in zip(shape, self.patch_shape)]
            if have_raw_channels and channel_first:
                pw_raw = [(0, 0), *pw]
            elif have_raw_channels and not channel_first:
                pw_raw = [*pw, (0, 0)]
            else:
                pw_raw = pw
            raw = np.pad(raw, pw_raw)
        return raw

    def _get_sample(self, index):
        if self.sample_random_index:
            index = np.random.randint(0, len(self.raw_images))

        raw = load_image(self.raw_images[index])
        have_raw_channels = raw.ndim == 3
        channel_first = None
        if have_raw_channels:
            channel_first = raw.shape[-1] > 16

        raw = self._ensure_patch_shape(raw, have_raw_channels, channel_first)
        shape = raw.shape
        if have_raw_channels:
            shape = shape[:-1]

        bb = self._sample_bounding_box(shape)
        raw_patch = np.array(raw[bb])

        if self.sampler is not None:
            sample_id = 0
            while not self.sampler(raw_patch):
                bb = self._sample_bounding_box(shape)
                raw_patch = np.array(raw[bb])
                sample_id += 1
                if sample_id > self.max_sampling_attempts:
                    raise RuntimeError(
                        f"Could not sample a valid batch in {self.max_sampling_attempts} attempts"
                    )

        if have_raw_channels:
            raw_patch = raw_patch.transpose((2, 0, 1))
        return raw_patch

    def __getitem__(self, index):
        raw = self._get_sample(index)
        if self.raw_transform is not None:
            raw = self.raw_transform(raw)
        if self.transform is not None:
            raw = self.transform(raw)
            if isinstance(raw, (list, tuple)):
                assert len(raw) == 1
                raw = raw[0]
        raw = ensure_array_with_channels(raw, ndim=self._ndim, dtype=self.dtype)
        if self.augmentations is not None:
            aug1, aug2 = self.augmentations
            raw1, raw2 = aug1(raw), aug2(raw)
            return (
                ensure_array_with_channels(raw1, ndim=self._ndim, dtype=self.dtype),
                ensure_array_with_channels(raw2, ndim=self._ndim, dtype=self.dtype),
            )
        return raw
