"""Instance-segmentation validation metrics: decode -> compare.

Rebuild of torch_em/metric/instance_segmentation_metric.py:
``BaseInstanceSegmentationMetric`` (:14) decodes each batch item to an
instance segmentation and compares to the GT instance channel (by convention
the LAST channel of the target, :33-34). Segmenters: ``MWS`` (:56),
``EmbeddingMWS`` (:83), ``Multicut`` (:123), ``HDBScan`` (:157). Measures:
IoU (:173), VOI (:185), RandError (:193), SymmetricBestDice (:201); plus the
14 prefab combinations (:214-461).

The port's copy of the JAX package's module. These run on the host during
validation (mutex watershed and multicut are sequential graph algorithms,
SURVEY.md §7 hard part #3); the trainer sees ``host_metric = True`` and hands
them the prediction and target as float32 numpy arrays after the validation
step. ``HDBScan`` clusters with the native ``ops.native.hdbscan``, which gives
scikit-learn's ``HDBSCAN`` labels id for id (sklearn is needed nowhere).
"""

from typing import List, Optional

import numpy as np
import torch

from ..ops import native
from ..ops.multicut import multicut_segmentation
from ..utils.segmentation import size_filter as _size_filter
from . import eval as elfval

__all__ = [
    "BaseInstanceSegmentationMetric", "MWS", "EmbeddingMWS", "Multicut", "HDBScan",
    "IOUError", "VariationOfInformation", "AdaptedRandError", "SymmetricBestDice",
    "EmbeddingMWSIOUMetric", "EmbeddingMWSSBDMetric", "EmbeddingMWSVOIMetric",
    "EmbeddingMWSRandMetric", "HDBScanIOUMetric", "HDBScanSBDMetric", "HDBScanRandMetric",
    "HDBScanVOIMetric", "MulticutVOIMetric", "MulticutRandMetric", "MWSIOUMetric",
    "MWSSBDMetric", "MWSVOIMetric", "MWSRandMetric", "embeddings_to_affinities",
]


class BaseInstanceSegmentationMetric:
    """Decode prediction -> instances -> compare to the GT instance channel."""

    host_metric = True  # evaluated on the host by the trainer

    def __init__(self, segmenter, metric, to_numpy: bool = True):
        self.segmenter = segmenter
        self.metric = metric
        self.to_numpy = to_numpy

    def __call__(self, input_, target):
        input_, target = _host(input_).astype("float32"), _host(target)
        assert input_.ndim == target.ndim
        assert len(input_) == len(target)
        scores = []
        for pred, trgt in zip(input_, target):
            seg = self.segmenter(pred)
            # GT instance channel is the last target channel by convention
            scores.append(self.metric(seg, trgt[-1].astype("uint32")))
        return float(np.mean(scores))


def _host(value) -> np.ndarray:
    """A numpy array of a numpy array or of a tensor on any device (bfloat16 as float32)."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        return (value.float() if value.dtype == torch.bfloat16 else value).cpu().numpy()
    return np.asarray(value)


# ---------------------------------------------------------------------------
# Segmenters
# ---------------------------------------------------------------------------

def filter_sizes(seg, min_seg_size, hmap=None):
    """@private"""
    if hmap is None:
        seg_ids, counts = np.unique(seg, return_counts=True)
        bg_ids = seg_ids[counts < min_seg_size]
        seg = seg.copy()
        seg[np.isin(seg, bg_ids)] = 0
        return seg
    return _size_filter(seg, min_seg_size, hmap=hmap)


class MWS:
    """Mutex-watershed decoding of affinity predictions (reference :56)."""

    def __init__(self, offsets, with_background, min_seg_size, strides=None):
        self.offsets = offsets
        self.with_background = with_background
        self.min_seg_size = min_seg_size
        if strides is None:
            strides = [4] * len(offsets[0])
        assert len(strides) == len(offsets[0])
        self.strides = strides

    def __call__(self, affinities):
        if self.with_background:
            assert len(affinities) == len(self.offsets) + 1
            mask, affinities = affinities[0], affinities[1:]
            mask = mask > 0.5
        else:
            assert len(affinities) == len(self.offsets)
            mask = None
        seg = native.mutex_watershed(
            affinities, self.offsets, strides=self.strides, randomize_strides=True, mask=mask
        ).astype("uint32")
        if self.min_seg_size > 0:
            seg = filter_sizes(seg, self.min_seg_size, hmap=None if self.with_background else affinities)
        return seg


def embeddings_to_affinities(embeddings: np.ndarray, offsets: List[List[int]], delta: float) -> np.ndarray:
    """Affinities (disaffinity convention) from embeddings via the
    discriminative-loss weight: attr = clamp((2*delta - d) / (2*delta), 0, 1)^2."""
    ndim = len(offsets[0])
    spatial = embeddings.shape[1:]
    affs = np.ones((len(offsets),) + spatial, dtype="float32")
    for c, off in enumerate(offsets):
        sl_src, sl_dst = [], []
        valid = True
        for o, s in zip(off, spatial):
            if abs(o) >= s:
                valid = False
                break
            if o > 0:
                sl_src.append(slice(None, -o)); sl_dst.append(slice(o, None))
            elif o < 0:
                sl_src.append(slice(-o, None)); sl_dst.append(slice(None, o))
            else:
                sl_src.append(slice(None)); sl_dst.append(slice(None))
        if not valid:
            continue
        sl_src, sl_dst = tuple(sl_src), tuple(sl_dst)
        dist = np.linalg.norm(
            embeddings[(slice(None),) + sl_src] - embeddings[(slice(None),) + sl_dst], axis=0
        )
        attr = np.clip((2 * delta - dist) / (2 * delta), 0, 1) ** 2
        affs[(c,) + sl_src] = 1.0 - attr  # disaffinity
    return affs


class EmbeddingMWS:
    """Mutex-watershed decoding of embedding predictions (reference :83)."""

    def __init__(self, delta, offsets, with_background, min_seg_size, strides=None):
        self.delta = delta
        self.offsets = offsets
        self.with_background = with_background
        self.min_seg_size = min_seg_size
        if strides is None:
            strides = [4] * len(offsets[0])
        assert len(strides) == len(offsets[0])
        self.strides = strides

    def merge_background(self, seg, embeddings):
        seg = seg + 1
        seg_ids, counts = np.unique(seg, return_counts=True)
        bg_seg = seg_ids[np.argmax(counts)]
        # mean embedding per segment
        emb_dim = embeddings.shape[0]
        flat_seg = seg.ravel()
        means = np.zeros((emb_dim, seg_ids.max() + 1), dtype="float64")
        for e in range(emb_dim):
            sums = np.bincount(flat_seg, weights=embeddings[e].ravel(), minlength=seg_ids.max() + 1)
            cnts = np.bincount(flat_seg, minlength=seg_ids.max() + 1)
            means[e] = sums / np.maximum(cnts, 1)
        bg_embed = means[:, bg_seg][:, None]
        dist = np.linalg.norm(means - bg_embed, axis=0)
        bg_probs = np.clip((2 * self.delta - dist) / (2 * self.delta), 0, 1) ** 2
        bg_ids = np.where(bg_probs > 0.5)[0]
        seg[np.isin(seg, bg_ids)] = 0
        from ..ops.host import label_consecutive

        return label_consecutive(seg)

    def __call__(self, embeddings):
        affs = embeddings_to_affinities(embeddings, self.offsets, self.delta)
        seg = native.mutex_watershed(
            affs, self.offsets, strides=self.strides, randomize_strides=True
        ).astype("uint32")
        if self.with_background:
            seg = self.merge_background(seg, embeddings)
        if self.min_seg_size > 0:
            seg = filter_sizes(seg, self.min_seg_size)
        return seg


class Multicut:
    """Multicut decoding of boundary predictions (reference :123)."""

    def __init__(self, min_seg_size, anisotropic=False, dt_threshold=0.25, sigma_seeds=2.0,
                 solver="gaec"):
        self.min_seg_size = min_seg_size
        self.anisotropic = anisotropic
        self.dt_threshold = dt_threshold
        self.sigma_seeds = sigma_seeds
        self.solver = solver

    def __call__(self, boundaries):
        if boundaries.shape[0] == 1:
            boundaries = boundaries[0]
        assert boundaries.ndim in (2, 3), f"{boundaries.ndim}"
        seg = multicut_segmentation(
            boundaries, threshold=self.dt_threshold, sigma_seeds=self.sigma_seeds,
            anisotropic=self.anisotropic,
        )
        if self.min_seg_size > 0:
            seg = filter_sizes(seg, self.min_seg_size, hmap=boundaries)
        return seg


class HDBScan:
    """HDBSCAN clustering of embedding predictions (reference :157): sklearn's
    ``HDBSCAN(min_cluster_size=min_size, cluster_selection_epsilon=eps)``, in native code."""

    def __init__(self, min_size, eps, remove_largest):
        self.min_size = min_size
        self.eps = eps
        self.remove_largest = remove_largest

    def __call__(self, embeddings):
        emb_dim = embeddings.shape[0]
        spatial = embeddings.shape[1:]
        points = embeddings.reshape(emb_dim, -1).T
        labels = native.hdbscan(points, self.min_size, self.eps) + 1  # -1 noise -> 0
        seg = labels.reshape(spatial).astype("uint32")
        if self.remove_largest and seg.max() > 0:
            ids, counts = np.unique(seg[seg != 0], return_counts=True)
            seg[seg == ids[np.argmax(counts)]] = 0
        return seg


# ---------------------------------------------------------------------------
# Measures
# ---------------------------------------------------------------------------

class IOUError:
    def __init__(self, threshold=0.5, metric="precision"):
        self.threshold = threshold
        self.metric = metric

    def __call__(self, seg, target):
        return 1.0 - elfval.matching(seg, target, threshold=self.threshold)[self.metric]


class VariationOfInformation:
    def __call__(self, seg, target):
        vis, vim = elfval.variation_of_information(seg, target)
        return vis + vim


class AdaptedRandError:
    def __call__(self, seg, target):
        are, _ = elfval.rand_index(seg, target)
        return are


class SymmetricBestDice:
    def __call__(self, seg, target):
        return 1.0 - elfval.symmetric_best_dice_score(seg, target)


# ---------------------------------------------------------------------------
# Prefab metrics (reference :214-461)
# ---------------------------------------------------------------------------

class EmbeddingMWSIOUMetric(BaseInstanceSegmentationMetric):
    def __init__(self, delta: float, offsets: List[List[int]], min_seg_size: int,
                 iou_threshold: float = 0.5, strides: Optional[List[int]] = None):
        segmenter = EmbeddingMWS(delta, offsets, with_background=True, min_seg_size=min_seg_size,
                                 strides=strides)
        super().__init__(segmenter, IOUError(threshold=iou_threshold))
        self.init_kwargs = {"delta": delta, "offsets": offsets, "min_seg_size": min_seg_size,
                            "iou_threshold": iou_threshold, "strides": strides}


class EmbeddingMWSSBDMetric(BaseInstanceSegmentationMetric):
    def __init__(self, delta: float, offsets: List[List[int]], min_seg_size: int,
                 strides: Optional[List[int]] = None):
        segmenter = EmbeddingMWS(delta, offsets, with_background=True, min_seg_size=min_seg_size,
                                 strides=strides)
        super().__init__(segmenter, SymmetricBestDice())
        self.init_kwargs = {"delta": delta, "offsets": offsets, "min_seg_size": min_seg_size,
                            "strides": strides}


class EmbeddingMWSVOIMetric(BaseInstanceSegmentationMetric):
    def __init__(self, delta: float, offsets: List[List[int]], min_seg_size: int,
                 strides: Optional[List[int]] = None):
        segmenter = EmbeddingMWS(delta, offsets, with_background=False, min_seg_size=min_seg_size,
                                 strides=strides)
        super().__init__(segmenter, VariationOfInformation())
        self.init_kwargs = {"delta": delta, "offsets": offsets, "min_seg_size": min_seg_size,
                            "strides": strides}


class EmbeddingMWSRandMetric(BaseInstanceSegmentationMetric):
    def __init__(self, delta: float, offsets: List[List[int]], min_seg_size: int,
                 strides: Optional[List[int]] = None):
        segmenter = EmbeddingMWS(delta, offsets, with_background=False, min_seg_size=min_seg_size,
                                 strides=strides)
        super().__init__(segmenter, AdaptedRandError())
        self.init_kwargs = {"delta": delta, "offsets": offsets, "min_seg_size": min_seg_size,
                            "strides": strides}


class HDBScanIOUMetric(BaseInstanceSegmentationMetric):
    def __init__(self, min_size: int, eps: float, iou_threshold: float = 0.5):
        segmenter = HDBScan(min_size=min_size, eps=eps, remove_largest=True)
        super().__init__(segmenter, IOUError(threshold=iou_threshold))
        self.init_kwargs = {"min_size": min_size, "eps": eps, "iou_threshold": iou_threshold}


class HDBScanSBDMetric(BaseInstanceSegmentationMetric):
    def __init__(self, min_size: int, eps: float):
        segmenter = HDBScan(min_size=min_size, eps=eps, remove_largest=True)
        super().__init__(segmenter, SymmetricBestDice())
        self.init_kwargs = {"min_size": min_size, "eps": eps}


class HDBScanRandMetric(BaseInstanceSegmentationMetric):
    def __init__(self, min_size: int, eps: float):
        segmenter = HDBScan(min_size=min_size, eps=eps, remove_largest=False)
        super().__init__(segmenter, AdaptedRandError())
        self.init_kwargs = {"min_size": min_size, "eps": eps}


class HDBScanVOIMetric(BaseInstanceSegmentationMetric):
    def __init__(self, min_size: int, eps: float):
        segmenter = HDBScan(min_size=min_size, eps=eps, remove_largest=False)
        super().__init__(segmenter, VariationOfInformation())
        self.init_kwargs = {"min_size": min_size, "eps": eps}


class MulticutVOIMetric(BaseInstanceSegmentationMetric):
    def __init__(self, min_seg_size: int, anisotropic: bool = False, dt_threshold: float = 0.25,
                 sigma_seeds: float = 2.0):
        segmenter = Multicut(min_seg_size, anisotropic, dt_threshold, sigma_seeds)
        super().__init__(segmenter, VariationOfInformation())
        self.init_kwargs = {"min_seg_size": min_seg_size, "anisotropic": anisotropic,
                            "dt_threshold": dt_threshold, "sigma_seeds": sigma_seeds}


class MulticutRandMetric(BaseInstanceSegmentationMetric):
    def __init__(self, min_seg_size: int, anisotropic: bool = False, dt_threshold: float = 0.25,
                 sigma_seeds: float = 2.0):
        segmenter = Multicut(min_seg_size, anisotropic, dt_threshold, sigma_seeds)
        super().__init__(segmenter, AdaptedRandError())
        self.init_kwargs = {"min_seg_size": min_seg_size, "anisotropic": anisotropic,
                            "dt_threshold": dt_threshold, "sigma_seeds": sigma_seeds}


class MWSIOUMetric(BaseInstanceSegmentationMetric):
    def __init__(self, offsets: List[List[int]], min_seg_size: int, iou_threshold: float = 0.5,
                 strides: Optional[List[int]] = None):
        segmenter = MWS(offsets, with_background=True, min_seg_size=min_seg_size, strides=strides)
        super().__init__(segmenter, IOUError(threshold=iou_threshold))
        self.init_kwargs = {"offsets": offsets, "min_seg_size": min_seg_size,
                            "iou_threshold": iou_threshold, "strides": strides}


class MWSSBDMetric(BaseInstanceSegmentationMetric):
    def __init__(self, offsets: List[List[int]], min_seg_size: int, strides: Optional[List[int]] = None):
        segmenter = MWS(offsets, with_background=True, min_seg_size=min_seg_size, strides=strides)
        super().__init__(segmenter, SymmetricBestDice())
        self.init_kwargs = {"offsets": offsets, "min_seg_size": min_seg_size, "strides": strides}


class MWSVOIMetric(BaseInstanceSegmentationMetric):
    def __init__(self, offsets: List[List[int]], min_seg_size: int, strides: Optional[List[int]] = None):
        segmenter = MWS(offsets, with_background=False, min_seg_size=min_seg_size, strides=strides)
        super().__init__(segmenter, VariationOfInformation())
        self.init_kwargs = {"offsets": offsets, "min_seg_size": min_seg_size, "strides": strides}


class MWSRandMetric(BaseInstanceSegmentationMetric):
    def __init__(self, offsets: List[List[int]], min_seg_size: int, strides: Optional[List[int]] = None):
        segmenter = MWS(offsets, with_background=False, min_seg_size=min_seg_size, strides=strides)
        super().__init__(segmenter, AdaptedRandError())
        self.init_kwargs = {"offsets": offsets, "min_seg_size": min_seg_size, "strides": strides}
