"""Random-forest pre-training for Shallow2Deep enhancers.

The port's own copy of ``torch_em_tpu/shallow2deep/prepare_shallow2deep.py``
(after torch-em's ``shallow2deep/prepare_shallow2deep.py``): the filter bank
(``_get_filters``, ``_apply_filters``), label balancing, the ensemble fitted
by a pool of threads (``prepare_shallow2deep``) and the stage-wise curricula
of ``prepare_shallow2deep_advanced`` with the sampling strategies
``worst_points``, ``uncertain_points``, ``uncertain_worst_points``,
``random_points``, ``worst_tiles`` and ``balanced_dense_accumulate``.

Patches, label balancing and sampling draw from the global ``np.random`` as
the JAX package does, and the forests are fitted by ``forest.fit_forest``,
which gives scikit-learn's ``RandomForestClassifier`` trees node for node
without sklearn: with one thread and the same seed, the forests equal the JAX
package's. Each forest is written as ``rf_XXXX.npz`` (``forest.save_forest``)
and as ``rf_XXXX.pkl``, the pickle of sklearn's ``RandomForestClassifier`` of
the same trees with its ``feature_ndim`` and ``feature_config``
(``forest.save_forest_pickle``, which needs no sklearn), so the folders of the
two packages and of torch-em are interchangeable on either machine.
``prepare_shallow2deep`` shows its progress with tqdm, imported when it is
called (an ``ImportError`` names it where it is missing). ``export_forests``
writes the other file of each forest of a folder fitted elsewhere: an ``.npz``
beside a pickle, a pickle beside an ``.npz``.
"""

import os
from concurrent import futures
from functools import partial
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

from ..data import ConcatDataset, ImageCollectionDataset, SegmentationDataset
from ..segmentation import check_paths, is_segmentation_dataset, samples_to_datasets
from . import filters as filter_impl
from .forest import fit_forest, load_forest, save_forest, save_forest_pickle

__all__ = [
    "prepare_shallow2deep", "prepare_shallow2deep_advanced", "worst_points", "uncertain_points",
    "uncertain_worst_points", "random_points", "worst_tiles", "balanced_dense_accumulate", "export_forests",
]


def _tqdm():
    try:
        from tqdm import tqdm
    except ImportError as e:
        raise ImportError("fitting the Shallow2Deep forests shows its progress with tqdm, which is not "
                          "installed") from e
    return tqdm


def _sample_box(shape, patch_shape_min, patch_shape_max):
    sample_shape = [
        pmin if pmin == pmax else np.random.randint(pmin, pmax)
        for pmin, pmax in zip(patch_shape_min, patch_shape_max)
    ]
    bb_start = [np.random.randint(0, sh - psh) if sh - psh > 0 else 0 for sh, psh in zip(shape, sample_shape)]
    return tuple(slice(start, start + psh) for start, psh in zip(bb_start, sample_shape))


class RFSegmentationDataset(SegmentationDataset):
    """``SegmentationDataset`` whose patches have a random shape between ``patch_shape_min`` and
    ``patch_shape_max`` (drawn per item), without padding."""

    patch_shape_min = None
    patch_shape_max = None

    def _sample_bounding_box(self):
        assert self.patch_shape_min is not None and self.patch_shape_max is not None
        return _sample_box(self.shape, self.patch_shape_min, self.patch_shape_max)

    def _get_sample(self, index):
        if self.raw is None or self.labels is None:
            raise RuntimeError("Dataset has not been properly deserialized.")
        bb = self._sample_bounding_box()
        raw, labels = np.asarray(self.raw[bb]), np.asarray(self.labels[bb])
        if self.sampler is not None:
            sample_id = 0
            while not self.sampler(raw, labels):
                bb = self._sample_bounding_box()
                raw, labels = np.asarray(self.raw[bb]), np.asarray(self.labels[bb])
                sample_id += 1
                if sample_id > self.max_sampling_attempts:
                    raise RuntimeError(f"Could not sample in {self.max_sampling_attempts} attempts")
        return raw, labels


class RFImageCollectionDataset(ImageCollectionDataset):
    """``ImageCollectionDataset`` with random patch shapes between ``patch_shape_min`` and
    ``patch_shape_max``."""

    patch_shape_min = None
    patch_shape_max = None

    def _sample_bounding_box(self, shape):
        if self.patch_shape_min is None:
            return super()._sample_bounding_box(shape)
        return _sample_box(shape, self.patch_shape_min, self.patch_shape_max)


def _load_rf_segmentation_dataset(raw_paths, raw_key, label_paths, label_key, patch_shape_min, patch_shape_max,
                                  **kwargs):
    rois = kwargs.pop("rois", None)

    def make(rp, lp, roi, **ds_kwargs):
        ds = RFSegmentationDataset(rp, raw_key, lp, label_key, roi=roi, patch_shape=patch_shape_min, **ds_kwargs)
        ds.patch_shape_min = patch_shape_min
        ds.patch_shape_max = patch_shape_max
        return ds

    if isinstance(raw_paths, str):
        return make(raw_paths, label_paths, rois, **kwargs)
    n_samples = kwargs.pop("n_samples", None)
    samples_per_ds = (
        [None] * len(raw_paths) if n_samples is None else samples_to_datasets(n_samples, raw_paths, raw_key)
    )
    return ConcatDataset(*[
        make(rp, lp, None if rois is None else rois[i], n_samples=samples_per_ds[i], **kwargs)
        for i, (rp, lp) in enumerate(zip(raw_paths, label_paths))
    ])


def _get_filters(ndim, filters_and_sigmas):
    """The (filter, sigma) pairs: ``filters_and_sigmas``, or ilastik's default bank of five
    filters at sigmas 0.7, 1.6, 3.5 and 5.0 (28 features in 2-D)."""
    if filters_and_sigmas is None:
        filters = [filter_impl.gaussianSmoothing,
                   filter_impl.laplacianOfGaussian,
                   filter_impl.gaussianGradientMagnitude,
                   filter_impl.hessianOfGaussianEigenvalues,
                   filter_impl.structureTensorEigenvalues]
        sigmas = [0.7, 1.6, 3.5, 5.0]
        filters_and_sigmas = [
            (filt, sigma) if i != len(filters) - 1 else (partial(filt, outerScale=0.5 * sigma), sigma)
            for i, filt in enumerate(filters) for sigma in sigmas
        ]
    assert isinstance(filters_and_sigmas, (list, tuple))
    for filt, sig in filters_and_sigmas:
        assert callable(filt) or (isinstance(filt, str) and hasattr(filter_impl, filt))
        assert isinstance(sig, (float, tuple))
    return filters_and_sigmas


def _calculate_response(raw, filter_, sigma):
    if callable(filter_):
        return filter_(raw, sigma)
    func = getattr(filter_impl, filter_)
    if filter_ == "structureTensorEigenvalues":
        outerScale = tuple(2 * s for s in sigma) if isinstance(sigma, tuple) else 2 * sigma
        return func(raw, sigma, outerScale=outerScale)
    return func(raw, sigma)


def _apply_filters(raw, filters_and_sigmas):
    """The feature matrix (n_pixels, n_features) of the filter bank."""
    features = []
    for filter_, sigma in filters_and_sigmas:
        response = _calculate_response(raw, filter_, sigma)
        if response.ndim > raw.ndim:
            for c in range(response.shape[-1]):
                features.append(response[..., c].flatten())
        else:
            features.append(response.flatten())
    return np.concatenate([ff[:, None] for ff in features], axis=1)


def _apply_filters_with_mask(raw, filters_and_sigmas, mask):
    features = []
    for filter_, sigma in filters_and_sigmas:
        response = _calculate_response(raw, filter_, sigma)
        if response.ndim > raw.ndim:
            for c in range(response.shape[-1]):
                features.append(response[..., c][mask])
        else:
            features.append(response[mask])
    return np.concatenate([ff[:, None] for ff in features], axis=1)


def _balance_labels(labels, mask):
    """Drop masked pixels at random until every class has as many as the rarest."""
    class_ids, label_counts = np.unique(labels[mask], return_counts=True)
    min_class = class_ids[np.argmin(label_counts)]
    n_labels = label_counts[np.argmin(label_counts)]

    for class_id in class_ids:
        if class_id == min_class:
            continue
        n_discard = int(np.sum((labels == class_id) & mask)) - n_labels
        label_pos = np.where((labels == class_id) & mask)
        discard_ids = np.arange(len(label_pos[0]))
        np.random.shuffle(discard_ids)
        discard_ids = discard_ids[:n_discard]
        mask[tuple(pos[discard_ids] for pos in label_pos)] = False
    return mask


def _get_features_and_labels(raw, labels, filters_and_sigmas, balance_labels, return_mask=False):
    assert labels.shape == raw.shape
    mask = labels != -1
    if balance_labels:
        mask = _balance_labels(labels, mask)
    masked_labels = labels[mask]
    features = _apply_filters_with_mask(raw, filters_and_sigmas, mask)
    assert len(features) == len(masked_labels)
    if return_mask:
        return features, masked_labels, mask
    return features, masked_labels


def _prepare_shallow2deep(raw_paths, raw_key, label_paths, label_key, patch_shape_min, patch_shape_max, n_forests,
                          ndim, raw_transform, label_transform, rois, is_seg_dataset, filter_config, sampler):
    assert len(patch_shape_min) == len(patch_shape_max)
    assert all(maxs >= mins for maxs, mins in zip(patch_shape_max, patch_shape_min))
    check_paths(raw_paths, label_paths)
    if is_seg_dataset is None:
        is_seg_dataset = is_segmentation_dataset(raw_paths, raw_key, label_paths, label_key)
    assert is_seg_dataset, "Image collection RF preparation requires container data, as in the JAX package."
    ds = _load_rf_segmentation_dataset(
        raw_paths, raw_key, label_paths, label_key, patch_shape_min, patch_shape_max,
        raw_transform=raw_transform, label_transform=label_transform, rois=rois,
        n_samples=n_forests, sampler=sampler,
    )
    assert len(ds) == n_forests, f"{len(ds)}, {n_forests}"
    return ds, _get_filters(ndim, filter_config)


def _serialize_feature_config(filters_and_sigmas):
    return [
        (filt if isinstance(filt, str) else
         (filt.func.__name__ if isinstance(filt, partial) else filt.__name__), sigma)
        for filt, sigma in filters_and_sigmas
    ]


def _get_raw_and_labels(ds, index, ndim):
    raw, labels = ds[index]
    raw = np.asarray(raw).squeeze()
    labels = np.asarray(labels).astype("int8").squeeze()
    assert raw.ndim == labels.ndim == ndim, f"{raw.ndim}, {labels.ndim}, {ndim}"
    return raw, labels


def _fit_forest(features, labels, ndim, feature_config, rf_kwargs):
    forest = fit_forest(features, labels, **rf_kwargs)
    forest.feature_ndim = ndim
    forest.feature_config = feature_config
    return forest


def _write_forest(forest, output_folder, rf_id):
    """``rf_XXXX.npz`` and the sklearn pickle ``rf_XXXX.pkl`` of the same trees."""
    path = os.path.join(output_folder, f"rf_{rf_id:04d}")
    save_forest(forest, path + ".npz")
    save_forest_pickle(forest, path + ".pkl")


def prepare_shallow2deep(
    raw_paths, raw_key, label_paths, label_key,
    patch_shape_min: Tuple[int, ...], patch_shape_max: Tuple[int, ...],
    n_forests: int, n_threads: int, output_folder: str, ndim: int,
    raw_transform: Optional[Callable] = None, label_transform: Optional[Callable] = None,
    rois=None, is_seg_dataset: Optional[bool] = None, balance_labels: bool = True,
    filter_config: Optional[Dict] = None, sampler: Optional[Callable] = None, **rf_kwargs,
) -> None:
    """Fit ``n_forests`` random forests (``fit_forest`` with ``rf_kwargs``), each on the filter-bank
    features of one random patch, with ``n_threads`` threads, and write them as
    ``output_folder/rf_XXXX.npz`` and ``.pkl``."""
    tqdm = _tqdm()
    os.makedirs(output_folder, exist_ok=True)
    ds, filters_and_sigmas = _prepare_shallow2deep(
        raw_paths, raw_key, label_paths, label_key, patch_shape_min, patch_shape_max,
        n_forests, ndim, raw_transform, label_transform, rois, is_seg_dataset, filter_config, sampler,
    )
    serialized_feature_config = _serialize_feature_config(filters_and_sigmas)

    def _train_rf(rf_id):
        raw, labels = _get_raw_and_labels(ds, rf_id, ndim)
        features, labels_flat = _get_features_and_labels(raw, labels, filters_and_sigmas, balance_labels)
        _write_forest(_fit_forest(features, labels_flat, ndim, serialized_feature_config, rf_kwargs), output_folder,
                      rf_id)

    with futures.ThreadPoolExecutor(n_threads) as tp:
        list(tqdm(tp.map(_train_rf, range(n_forests)), desc="Train RFs", total=n_forests))


def _score_based_points(score_function, features, labels, rf_id, forests, forests_per_stage,
                        sample_fraction_per_stage, accumulate_samples):
    last_forest = forests[rf_id - forests_per_stage]
    score = score_function(last_forest.predict_proba(features), labels)
    assert len(score) == len(features)

    samples = []
    nc = len(np.unique(labels))
    n_samples_class = max(int(sample_fraction_per_stage * len(features)) // nc, 1)
    for class_id in np.unique(labels):
        class_indices = np.where(labels == class_id)[0]
        samples.append(class_indices[np.argsort(score[class_indices])[::-1][:n_samples_class]])
    samples = np.concatenate(samples)

    features, labels = features[samples], labels[samples]
    if accumulate_samples and hasattr(last_forest, "train_features"):
        features = np.concatenate([last_forest.train_features, features], axis=0)
        labels = np.concatenate([last_forest.train_labels, labels], axis=0)
    return features, labels


def worst_points(features, labels, rf_id, forests, forests_per_stage, sample_fraction_per_stage,
                 accumulate_samples=True, **kwargs):
    """Sample, per class, where the previous stage's forest is most wrong."""
    def score(pred, labels):
        one_hot = np.eye(pred.shape[1])[labels.astype(int)]
        return np.abs(pred - one_hot).sum(axis=1)

    return _score_based_points(score, features, labels, rf_id, forests, forests_per_stage,
                               sample_fraction_per_stage, accumulate_samples)


def uncertain_points(features, labels, rf_id, forests, forests_per_stage, sample_fraction_per_stage,
                     accumulate_samples=True, **kwargs):
    """Sample, per class, where the previous stage's forest is least certain."""
    def score(pred, labels):
        sorted_pred = np.sort(pred, axis=1)
        return 1.0 - (sorted_pred[:, -1] - sorted_pred[:, -2])

    return _score_based_points(score, features, labels, rf_id, forests, forests_per_stage,
                               sample_fraction_per_stage, accumulate_samples)


def uncertain_worst_points(features, labels, rf_id, forests, forests_per_stage, sample_fraction_per_stage,
                           accumulate_samples=True, alpha=0.5, **kwargs):
    """Sample by ``alpha`` times the error plus ``1 - alpha`` times the uncertainty."""
    def score(pred, labels):
        one_hot = np.eye(pred.shape[1])[labels.astype(int)]
        diff = np.abs(pred - one_hot).sum(axis=1)
        sorted_pred = np.sort(pred, axis=1)
        uncertainty = 1.0 - (sorted_pred[:, -1] - sorted_pred[:, -2])
        return alpha * diff + (1.0 - alpha) * uncertainty

    return _score_based_points(score, features, labels, rf_id, forests, forests_per_stage,
                               sample_fraction_per_stage, accumulate_samples)


def random_points(features, labels, rf_id, forests, forests_per_stage, sample_fraction_per_stage,
                  accumulate_samples=True, **kwargs):
    """Sample at random, balanced over the classes."""
    samples = []
    nc = len(np.unique(labels))
    n_samples_class = max(int(sample_fraction_per_stage * len(features)) // nc, 1)
    for class_id in np.unique(labels):
        class_indices = np.where(labels == class_id)[0]
        samples.append(np.random.choice(class_indices, size=min(n_samples_class, len(class_indices)),
                                        replace=False))
    samples = np.concatenate(samples)
    features, labels = features[samples], labels[samples]
    if accumulate_samples and forests and hasattr(forests[max(rf_id - forests_per_stage, 0)], "train_features"):
        last_forest = forests[rf_id - forests_per_stage]
        features = np.concatenate([last_forest.train_features, features], axis=0)
        labels = np.concatenate([last_forest.train_labels, labels], axis=0)
    return features, labels


def worst_tiles(features, labels, rf_id, forests, forests_per_stage, sample_fraction_per_stage,
                img_shape=None, mask=None, tile_shape=(25, 25), smoothing_sigma=None,
                accumulate_samples=True, **kwargs):
    """Sample the pixels where the previous stage's forest is most wrong, as the JAX package
    realises torch-em's dense tiles around the worst points."""
    last_forest = forests[rf_id - forests_per_stage]
    pred = last_forest.predict_proba(features)
    one_hot = np.eye(pred.shape[1])[labels.astype(int)]
    diff = np.abs(pred - one_hot).sum(axis=1)
    samples = np.argsort(diff)[::-1][:int(sample_fraction_per_stage * len(features))]
    features, labels = features[samples], labels[samples]
    if accumulate_samples and hasattr(last_forest, "train_features"):
        features = np.concatenate([last_forest.train_features, features], axis=0)
        labels = np.concatenate([last_forest.train_labels, labels], axis=0)
    return features, labels


def balanced_dense_accumulate(features, labels, rf_id, forests, forests_per_stage, sample_fraction_per_stage,
                              accumulate_samples=True, **kwargs):
    """Dense accumulation with class balancing: ``random_points``."""
    return random_points(features, labels, rf_id, forests, forests_per_stage, sample_fraction_per_stage,
                         accumulate_samples=accumulate_samples)


SAMPLING_STRATEGIES = {
    "worst_points": worst_points,
    "uncertain_points": uncertain_points,
    "uncertain_worst_points": uncertain_worst_points,
    "random_points": random_points,
    "worst_tiles": worst_tiles,
    "balanced_dense_accumulate": balanced_dense_accumulate,
}


def prepare_shallow2deep_advanced(
    raw_paths, raw_key, label_paths, label_key,
    patch_shape_min: Tuple[int, ...], patch_shape_max: Tuple[int, ...],
    n_forests: int, n_threads: int, output_folder: str, ndim: int,
    forests_per_stage: int, sample_fraction_per_stage: float,
    sampling_strategy: Union[str, Callable] = "worst_points",
    sampling_kwargs: Optional[Dict] = None,
    raw_transform: Optional[Callable] = None, label_transform: Optional[Callable] = None,
    rois=None, is_seg_dataset: Optional[bool] = None, balance_labels: bool = True,
    filter_config: Optional[Dict] = None, sampler: Optional[Callable] = None, **rf_kwargs,
) -> None:
    """Fit the forests stage by stage: the first stage on balanced patches, each later one on the
    samples that ``sampling_strategy`` picks by the previous stage's forests. Each forest keeps its
    ``train_features`` and ``train_labels``, which the strategies read, and is written as
    ``output_folder/rf_XXXX.npz`` and ``.pkl`` (the pickle with them)."""
    os.makedirs(output_folder, exist_ok=True)
    ds, filters_and_sigmas = _prepare_shallow2deep(
        raw_paths, raw_key, label_paths, label_key, patch_shape_min, patch_shape_max,
        n_forests, ndim, raw_transform, label_transform, rois, is_seg_dataset, filter_config, sampler,
    )
    serialized_feature_config = _serialize_feature_config(filters_and_sigmas)
    strategy = SAMPLING_STRATEGIES[sampling_strategy] if isinstance(sampling_strategy, str) else sampling_strategy
    sampling_kwargs = {} if sampling_kwargs is None else sampling_kwargs

    forests = []
    rf_id = 0
    for stage in range(int(np.ceil(n_forests / forests_per_stage))):
        stage_forests = []
        for _ in range(min(forests_per_stage, n_forests - rf_id)):
            raw, labels = _get_raw_and_labels(ds, rf_id, ndim)
            features, labels_flat = _get_features_and_labels(raw, labels, filters_and_sigmas, balance_labels)
            if stage > 0:
                features, labels_flat = strategy(features, labels_flat, rf_id, forests, forests_per_stage,
                                                 sample_fraction_per_stage, **sampling_kwargs)
            rf = _fit_forest(features, labels_flat, ndim, serialized_feature_config, rf_kwargs)
            rf.train_features = features
            rf.train_labels = labels_flat
            _write_forest(rf, output_folder, rf_id)
            stage_forests.append(rf)
            rf_id += 1
        forests.extend(stage_forests)


def export_forests(folder: str) -> list:
    """Write the file a forest of ``folder`` lacks: ``rf_XXXX.npz`` (``forest.save_forest``) beside each
    ``rf_XXXX.pkl`` that has none, the sklearn pickle (``forest.save_forest_pickle``) beside each
    ``.npz`` that has none. Returns the written paths, sorted. Needs no sklearn."""
    names = set(os.listdir(folder))
    out = []
    for name in sorted(names):
        stem, ext = os.path.splitext(name)
        other = {".pkl": ".npz", ".npz": ".pkl"}.get(ext)
        if other is None or stem + other in names:
            continue
        out.append(os.path.join(folder, stem + other))
        (save_forest if other == ".npz" else save_forest_pickle)(load_forest(os.path.join(folder, name)), out[-1])
    return sorted(out)
