"""Instance-segmentation decodings: watersheds and the mutex watershed.

Rebuild of torch_em/util/segmentation.py: ``size_filter`` (:23),
``mutex_watershed_segmentation`` (:56), ``connected_components_with_boundaries``
(:87), ``watershed_from_components`` (:107), ``watershed_from_maxima`` (:139),
``watershed_from_center_and_boundary_distances`` (:179). The graph algorithms
(watershed priority flood, mutex watershed Kruskal) run in the native C++
extension (``ops/native``, the port's own copy of the JAX package's) instead of
elf/vigra/skimage. The port's copy of the JAX package's ``utils/segmentation.py``;
its decodings give the same labels on the same inputs.
"""

from typing import List, Optional

import numpy as np
from scipy import ndimage

from ..ops import host as ops
from ..ops import native

__all__ = [
    "size_filter", "mutex_watershed_segmentation", "connected_components_with_boundaries",
    "watershed_from_components", "watershed_from_maxima",
    "watershed_from_center_and_boundary_distances",
]


def _apply_size_filter_with_hmap(seg, hmap, min_size, with_background):
    """Remove small segments and grow the survivors back via seeded watershed
    (functional spec: elf.segmentation.watershed.apply_size_filter)."""
    ids, sizes = np.unique(seg, return_counts=True)
    discard = set(int(i) for i, s in zip(ids, sizes) if s < min_size)
    if with_background:
        discard.discard(0)
    if not discard:
        return seg
    seeds = seg.copy().astype("uint32")
    seeds[np.isin(seg, list(discard))] = 0
    mask = seg != 0 if with_background else None
    grown = native.watershed(hmap.astype("float32"), seeds, mask=mask)
    return grown


def size_filter(
    seg: np.ndarray, min_size: int, hmap: Optional[np.ndarray] = None, with_background: bool = False
) -> np.ndarray:
    """Remove small segments (reference util/segmentation.py:23).

    Without a heightmap small segments become background; with one, the
    vacated area is regrown from the remaining segments by seeded watershed.
    """
    if min_size == 0:
        return seg
    if hmap is None:
        ids, sizes = np.unique(seg, return_counts=True)
        bg_ids = ids[sizes < min_size]
        seg = seg.copy()
        seg[np.isin(seg, bg_ids)] = 0
        seg, _, _ = ops.relabel_consecutive(seg.astype("uint32"), start_label=1, keep_zeros=True)
        return seg
    assert hmap.ndim in (seg.ndim, seg.ndim + 1)
    hmap_ = np.max(hmap[: seg.ndim], axis=0) if hmap.ndim > seg.ndim else hmap
    return _apply_size_filter_with_hmap(seg, hmap_, min_size, with_background)


def mutex_watershed_segmentation(
    foreground: np.ndarray,
    affinities: np.ndarray,
    offsets: List[List[int]],
    min_size: int = 50,
    threshold: float = 0.5,
    strides: Optional[List[int]] = None,
) -> np.ndarray:
    """Mutex-watershed instance segmentation from affinities
    (reference util/segmentation.py:56).

    ``affinities`` follow the training (disaffinity) convention, 1 = boundary,
    as ``AffinityTransform`` makes them and a model trained on it predicts
    them. ``strides`` (default 2 per axis) subsample the repulsive edges at
    random, from a generator with the fixed seed 0, so the result is
    deterministic.
    """
    mask = foreground >= threshold
    if strides is None:
        strides = [2] * foreground.ndim
    seg = native.mutex_watershed(
        affinities, offsets=offsets, mask=mask, strides=strides, randomize_strides=True
    )
    seg = size_filter(seg.astype("uint32"), min_size=min_size, hmap=affinities, with_background=True)
    return seg


def connected_components_with_boundaries(
    foreground: np.ndarray, boundaries: np.ndarray, threshold: float = 0.5
) -> np.ndarray:
    """Instances from foreground + boundary maps (reference util/segmentation.py:87)."""
    input_ = np.clip(foreground - boundaries, 0, 1)
    seeds = ops.connected_components(input_ > threshold)
    mask = foreground > threshold
    seg = native.watershed(boundaries.astype("float32"), seeds.astype("uint32"), mask=mask)
    return seg.astype("uint64")


def watershed_from_components(
    boundaries: np.ndarray,
    foreground: np.ndarray,
    min_size: int = 50,
    threshold1: float = 0.5,
    threshold2: float = 0.5,
) -> np.ndarray:
    """Seeded watershed from (foreground - boundaries) components
    (reference util/segmentation.py:107)."""
    seeds = ops.connected_components((foreground - boundaries) > threshold1)
    mask = foreground > threshold2
    seg = native.watershed(boundaries.astype("float32"), seeds.astype("uint32"), mask=mask)
    seg = size_filter(seg, min_size)
    return seg


def watershed_from_maxima(
    boundaries: np.ndarray,
    foreground: np.ndarray,
    min_distance: int,
    min_size: int = 50,
    sigma: float = 1.0,
    threshold1: float = 0.5,
) -> np.ndarray:
    """Seeded watershed from distance maxima (reference util/segmentation.py:139)."""
    mask = foreground > threshold1
    boundary_distances = ndimage.distance_transform_edt(boundaries < 0.1)
    boundary_distances[~mask] = 0
    boundary_distances = ndimage.gaussian_filter(boundary_distances, sigma)
    seed_points = ops.peak_local_max(boundary_distances, min_distance=min_distance, exclude_border=False)
    seeds = np.zeros(mask.shape, dtype="uint32")
    if len(seed_points):
        seeds[tuple(seed_points.T)] = np.arange(1, len(seed_points) + 1)
    seg = native.watershed(boundaries.astype("float32"), seeds, mask=foreground > 0)
    return size_filter(seg, min_size)


def watershed_from_center_and_boundary_distances(
    center_distances: np.ndarray,
    boundary_distances: np.ndarray,
    foreground_map: np.ndarray,
    center_distance_threshold: float = 0.5,
    boundary_distance_threshold: float = 0.5,
    foreground_threshold: float = 0.5,
    distance_smoothing: float = 1.6,
    min_size: int = 0,
    debug: bool = False,
):
    """Seeded watershed on center+boundary distance predictions
    (reference util/segmentation.py:179)."""
    if distance_smoothing > 0:
        center_distances = ndimage.gaussian_filter(center_distances, distance_smoothing)
        boundary_distances = ndimage.gaussian_filter(boundary_distances, distance_smoothing)

    fg_mask = foreground_map > foreground_threshold
    marker_map = np.logical_and(
        center_distances < center_distance_threshold, boundary_distances < boundary_distance_threshold
    )
    marker_map[~fg_mask] = 0
    markers = ops.connected_components(marker_map)

    seg = native.watershed(boundary_distances.astype("float32"), markers.astype("uint32"), mask=fg_mask)
    seg = size_filter(seg, min_size)

    if debug:
        return seg, {
            "center_distances": center_distances,
            "boundary_distances": boundary_distances,
            "foreground_mask": fg_mask,
            "markers": markers,
        }
    return seg
