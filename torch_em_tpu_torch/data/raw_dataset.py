"""Raw-only (unsupervised) patch dataset over volumes.

The port's own copy of ``torch_em_tpu/data/raw_dataset.py`` (after
torch-em's ``data/raw_dataset.py``): raw patches only, with optional
two-view ``augmentations`` for contrastive and self-training, and
``RawDatasetWithMasks``, which adds a foreground mask derived from the raw
data.
"""

import os
import warnings
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np

from ..utils.io import RoiWrapper, load_data
from ..utils.tensor import ensure_array_with_channels, ensure_patch_shape
from .base import Dataset
from .segmentation_dataset import _normalize_roi


class RawDataset(Dataset):
    """Dataset providing raw patches only (for unsupervised / self-training)."""

    max_sampling_attempts = 500

    @staticmethod
    def compute_len(shape, patch_shape):
        return int(np.prod([float(sh / csh) for sh, csh in zip(shape, patch_shape)]))

    def __init__(
        self,
        raw_path: Union[List[Any], str, os.PathLike],
        raw_key: Optional[str],
        patch_shape: Tuple[int, ...],
        raw_transform: Optional[Callable] = None,
        transform: Optional[Callable] = None,
        roi: Optional[Union[slice, Tuple[slice, ...]]] = None,
        dtype="float32",
        n_samples: Optional[int] = None,
        sampler: Optional[Callable] = None,
        ndim: Optional[int] = None,
        with_channels: bool = False,
        augmentations: Optional[Tuple[Callable, Callable]] = None,
    ):
        self.raw_path = raw_path
        self.raw_key = raw_key
        self.raw = load_data(raw_path, raw_key)
        self._with_channels = with_channels

        if roi is not None:
            shape = self.raw.shape[1:] if self._with_channels else self.raw.shape
            roi = _normalize_roi(roi, shape)
            self.raw = RoiWrapper(self.raw, (slice(None),) + roi) if self._with_channels \
                else RoiWrapper(self.raw, roi)

        self.shape = tuple(self.raw.shape[1:] if self._with_channels else self.raw.shape)
        self.roi = roi

        self._ndim = len(self.shape) if ndim is None else ndim
        assert self._ndim in (2, 3, 4), f"Invalid data dimensions: {self._ndim}."
        assert len(patch_shape) in (self._ndim, self._ndim + 1), f"{patch_shape}, {self._ndim}"
        self.patch_shape = tuple(patch_shape)

        self.raw_transform = raw_transform
        self.transform = transform
        self.sampler = sampler
        self.dtype = dtype

        if augmentations is not None:
            assert len(augmentations) == 2
        self.augmentations = augmentations

        self._len = self.compute_len(self.shape, self.patch_shape) if n_samples is None else n_samples
        self.sample_shape = self.patch_shape
        self.trafo_halo = None

        self.init_kwargs = {
            "raw_path": raw_path, "raw_key": raw_key, "patch_shape": patch_shape,
            "raw_transform": raw_transform, "transform": transform, "roi": roi, "dtype": dtype,
            "n_samples": n_samples, "sampler": sampler, "ndim": ndim, "with_channels": with_channels,
            "augmentations": augmentations,
        }

    def __len__(self):
        return self._len

    @property
    def ndim(self):
        return self._ndim

    def _sample_bounding_box(self):
        bb_start = [
            np.random.randint(0, sh - psh) if sh - psh > 0 else 0
            for sh, psh in zip(self.shape, self.sample_shape)
        ]
        return tuple(slice(start, start + psh) for start, psh in zip(bb_start, self.sample_shape))

    def _get_sample(self, index):
        if self.raw is None:
            raise RuntimeError("RawDataset has not been properly deserialized.")
        bb = self._sample_bounding_box()
        raw = np.asarray(self.raw[(slice(None),) + bb] if self._with_channels else self.raw[bb])

        if self.sampler is not None:
            sample_id = 0
            while not self.sampler(raw):
                bb = self._sample_bounding_box()
                raw = np.asarray(self.raw[(slice(None),) + bb] if self._with_channels else self.raw[bb])
                sample_id += 1
                if sample_id > self.max_sampling_attempts:
                    raise RuntimeError(
                        f"Could not sample a valid batch in {self.max_sampling_attempts} attempts"
                    )

        if self.patch_shape is not None:
            raw = ensure_patch_shape(
                raw=raw, labels=None, patch_shape=self.patch_shape, have_raw_channels=self._with_channels
            )

        if len(self.patch_shape) == self._ndim + 1:
            raw = np.squeeze(raw, axis=1 if self._with_channels else 0)
        return raw

    def __getitem__(self, index):
        raw = self._get_sample(index)

        if self.raw_transform is not None:
            raw = self.raw_transform(raw)
        if self.transform is not None:
            raw = self.transform(raw)
            if isinstance(raw, list):
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

    def __getstate__(self):
        state = self.__dict__.copy()
        del state["raw"]
        return state

    def __setstate__(self, state):
        roi = state["roi"]
        try:
            raw = load_data(state["raw_path"], state["raw_key"])
            if roi is not None:
                raw = RoiWrapper(raw, (slice(None),) + roi) if state["_with_channels"] else RoiWrapper(raw, roi)
            state["raw"] = raw
        except Exception:
            warnings.warn(
                f"RawDataset could not be deserialized because of missing "
                f"{state['raw_path']}, {state['raw_key']}."
            )
            state["raw"] = None
        self.__dict__.update(state)


class RawDatasetWithMasks(RawDataset):
    """RawDataset variant that additionally returns a foreground mask derived
    from the raw data (torch-em raw_dataset.py:280 region)."""

    def __init__(self, *args, mask_transform: Optional[Callable] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mask_transform = mask_transform
        self.init_kwargs["mask_transform"] = mask_transform

    def __getitem__(self, index):
        raw = self._get_sample(index)
        if self.raw_transform is not None:
            raw = self.raw_transform(raw)
        if self.transform is not None:
            raw = self.transform(raw)
            if isinstance(raw, list):
                assert len(raw) == 1
                raw = raw[0]
        raw = ensure_array_with_channels(raw, ndim=self._ndim, dtype=self.dtype)
        if self.mask_transform is None:
            mask = np.ones_like(raw, dtype="bool")
        else:
            mask = self.mask_transform(raw)
        return raw, mask
