"""Datasets that train a Shallow2Deep enhancer.

The port's own copy of ``torch_em_tpu/shallow2deep/shallow2deep_dataset.py``
(after torch-em's ``shallow2deep/shallow2deep_dataset.py``): for each item a
forest is drawn from the ensemble with ``np.random.randint``, as the JAX
package draws it, and the sample is (the forest's probabilities for
``rf_channels`` on the filter-bank features of the raw patch, the labels): the
enhancer learns to turn a forest's prediction into the ground truth.

``rf_paths`` may name pickled sklearn forests (``.pkl``) or the port's
``.npz`` forests; ``forest.load_forest`` reads both with numpy alone; either
way the port computes the probabilities with ``Forest.predict_proba``, which
equals sklearn's. A dataset keeps each forest it has loaded, which changes no
draw. The forests, the filter config and the channels are constructor
arguments and stand in ``init_kwargs``, so a trainer checkpoint rebuilds the
dataset.
"""

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from ..data import ConcatDataset, DataLoader, ImageCollectionDataset, SegmentationDataset
from ..segmentation import check_paths, get_data_loader, is_segmentation_dataset, samples_to_datasets
from ..utils.tensor import ensure_array_with_channels, ensure_spatial_array
from .forest import load_forest
from .prepare_shallow2deep import _apply_filters, _get_filters

__all__ = ["Shallow2DeepDataset", "Shallow2DeepImageCollectionDataset", "get_shallow2deep_dataset",
           "get_shallow2deep_loader"]


class _Shallow2DeepBase:
    """The forests' prediction on a raw patch."""

    def _init_shallow2deep(self, rf_paths, filter_config, rf_channels):
        self.rf_paths = None if rf_paths is None else list(rf_paths)
        self.filter_config = filter_config
        self.rf_channels = (rf_channels,) if isinstance(rf_channels, int) else tuple(rf_channels)
        self._forests = {}
        self.init_kwargs.update({"rf_paths": self.rf_paths, "filter_config": filter_config,
                                 "rf_channels": self.rf_channels})

    def _forest(self, path):
        if path not in self._forests:
            self._forests[path] = load_forest(path)
        return self._forests[path]

    def _predict(self, raw, rf, filters_and_sigmas):
        features = _apply_filters(np.asarray(raw, dtype="float32"), filters_and_sigmas)
        assert rf.n_features_in_ == features.shape[1], f"{rf.n_features_in_}, {features.shape[1]}"
        try:
            pred_ = rf.predict_proba(features)
            assert pred_.shape[1] > max(self.rf_channels), f"{pred_.shape}, {self.rf_channels}"
            pred_ = pred_[:, self.rf_channels]
        except IndexError:
            pred_ = np.zeros((len(features), len(self.rf_channels)), dtype="float32")
        spatial_shape = np.asarray(raw).shape
        prediction = np.zeros((len(self.rf_channels),) + spatial_shape, dtype="float32")
        for chan in range(pred_.shape[1]):
            prediction[chan] = pred_[:, chan].reshape(spatial_shape)
        return prediction

    def _predict_rf(self, raw):
        if not self.rf_paths:
            raise ValueError("the dataset has no forests (rf_paths)")
        rf_path = self.rf_paths[np.random.randint(0, len(self.rf_paths))]
        return self._predict(raw, self._forest(rf_path), _get_filters(self._ndim, self.filter_config))

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

        prediction = self._predict_rf(np.asarray(raw).squeeze())
        prediction = ensure_array_with_channels(prediction, ndim=self._ndim, dtype=self.dtype)
        labels = ensure_array_with_channels(labels, ndim=self._ndim, dtype=self.label_dtype)
        return prediction, labels


class Shallow2DeepDataset(_Shallow2DeepBase, SegmentationDataset):
    """``SegmentationDataset`` whose samples are (forest prediction, labels)."""

    def __init__(self, *args, rf_paths: Optional[Sequence[str]] = None, filter_config=None,
                 rf_channels: Tuple[int, ...] = (1,), **kwargs):
        SegmentationDataset.__init__(self, *args, **kwargs)
        self._init_shallow2deep(rf_paths, filter_config, rf_channels)


class Shallow2DeepImageCollectionDataset(_Shallow2DeepBase, ImageCollectionDataset):
    """``ImageCollectionDataset`` whose samples are (forest prediction, labels)."""

    def __init__(self, *args, rf_paths: Optional[Sequence[str]] = None, filter_config=None,
                 rf_channels: Tuple[int, ...] = (1,), **kwargs):
        ImageCollectionDataset.__init__(self, *args, **kwargs)
        self._init_shallow2deep(rf_paths, filter_config, rf_channels)


def _load_shallow2deep_segmentation_dataset(raw_paths, raw_key, label_paths, label_key, rf_paths, rf_channels, ndim,
                                            **kwargs):
    rois = kwargs.pop("rois", None)
    filter_config = kwargs.pop("filter_config", None)
    if ndim == "anisotropic":
        ndim = 3

    def make(rp, lp, roi, n_samples):
        return Shallow2DeepDataset(rp, raw_key, lp, label_key, roi=roi, ndim=ndim, n_samples=n_samples,
                                   rf_paths=rf_paths, filter_config=filter_config, rf_channels=rf_channels,
                                   **kwargs)

    n_samples = kwargs.pop("n_samples", None)
    if isinstance(raw_paths, str):
        return make(raw_paths, label_paths, rois, n_samples)
    samples_per_ds = (
        [None] * len(raw_paths) if n_samples is None else samples_to_datasets(n_samples, raw_paths, raw_key)
    )
    return ConcatDataset(*[make(rp, lp, None if rois is None else rois[i], samples_per_ds[i])
                           for i, (rp, lp) in enumerate(zip(raw_paths, label_paths))])


def get_shallow2deep_dataset(
    raw_paths, raw_key, label_paths, label_key,
    rf_paths: Sequence[str],
    patch_shape: Tuple[int, ...],
    raw_transform: Optional[Callable] = None,
    transform: Optional[Callable] = None,
    rois=None,
    n_samples: Optional[int] = None,
    sampler: Optional[Callable] = None,
    ndim=None,
    is_seg_dataset: Optional[bool] = None,
    with_channels: bool = False,
    filter_config=None,
    rf_channels: Tuple[int, ...] = (1,),
    **kwargs,
):
    """A Shallow2Deep dataset over container data (``Shallow2DeepDataset``, or a
    ``ConcatDataset`` of them for several paths)."""
    check_paths(raw_paths, label_paths)
    if is_seg_dataset is None:
        is_seg_dataset = is_segmentation_dataset(raw_paths, raw_key, label_paths, label_key)
    if isinstance(rf_channels, int):
        rf_channels = (rf_channels,)
    assert is_seg_dataset, "Image collection Shallow2Deep datasets require container data, as in the JAX package."
    return _load_shallow2deep_segmentation_dataset(
        raw_paths, raw_key, label_paths, label_key, rf_paths, rf_channels, ndim,
        patch_shape=patch_shape, raw_transform=raw_transform, transform=transform, rois=rois,
        n_samples=n_samples, sampler=sampler, with_channels=with_channels, filter_config=filter_config, **kwargs,
    )


def get_shallow2deep_loader(
    raw_paths, raw_key, label_paths, label_key,
    rf_paths: Sequence[str],
    batch_size: int,
    patch_shape: Tuple[int, ...],
    **kwargs,
) -> DataLoader:
    """A loader over ``get_shallow2deep_dataset``; ``shuffle``, ``num_workers``, ``drop_last``,
    ``prefetch_factor`` and ``worker_mode`` go to the loader."""
    loader_kwargs = {k: kwargs.pop(k) for k in ("shuffle", "num_workers", "drop_last", "prefetch_factor",
                                                 "worker_mode") if k in kwargs}
    ds = get_shallow2deep_dataset(raw_paths, raw_key, label_paths, label_key, rf_paths, patch_shape, **kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
