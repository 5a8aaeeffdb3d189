"""Label transforms: instance segmentation -> trainable targets, on the host.

The port's own copy of ``torch_em_tpu/transforms/label.py`` (after torch-em's
``transform/label.py``): ``BoundaryTransform``,
``NoToBackgroundBoundaryTransform``, ``BoundaryTransformWithIgnoreLabel``,
``AffinityTransform``, ``OneHotTransform``, ``DistanceTransform``,
``PerObjectDistanceTransform`` and ``MinSizeLabelTransform``, with
affinities by numpy shift-and-compare and distances by scipy's exact EDT
(``ops/host.py``). They run per sample in the data loader; ``ops/device.py``
computes affinities and boundaries for a batch inside the training step.
Each transform keeps ``init_kwargs``, so that a trainer checkpoint rebuilds it.
"""

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..ops import host as ops
from ..utils.tensor import ensure_array, ensure_spatial_array

__all__ = [
    "connected_components", "labels_to_binary", "label_consecutive",
    "MinSizeLabelTransform", "BoundaryTransform", "NoToBackgroundBoundaryTransform",
    "BoundaryTransformWithIgnoreLabel", "AffinityTransform", "OneHotTransform",
    "DistanceTransform", "PerObjectDistanceTransform",
]


def connected_components(labels: np.ndarray, ndim: Optional[int] = None, ensure_zero: bool = False) -> np.ndarray:
    """Connected components of a segmentation (torch-em label.py:16)."""
    labels = ensure_array(labels) if ndim is None else ensure_spatial_array(labels, ndim)
    labels = ops.connected_components(labels, with_background=True)
    if ensure_zero and 0 not in labels:
        labels = labels - 1
    return labels


def labels_to_binary(labels: np.ndarray, background_label: int = 0) -> np.ndarray:
    """Binarize a segmentation (torch-em label.py:34)."""
    return (labels != background_label).astype(labels.dtype)


def label_consecutive(labels: np.ndarray, with_background: bool = True) -> np.ndarray:
    """Relabel ids consecutively (torch-em label.py:47)."""
    if with_background:
        return ops.label_consecutive(labels, with_background=True)
    labels = np.asarray(labels)
    if 0 in labels:
        labels = labels + 1
    seg = ops.label_consecutive(labels, with_background=True)
    return seg - 1


class MinSizeLabelTransform:
    """Connected components + small-object removal (torch-em label.py:68)."""

    def __init__(self, min_size: Optional[int] = None, ndim: Optional[int] = None, ensure_zero: bool = False):
        self.min_size = min_size
        self.ndim = ndim
        self.ensure_zero = ensure_zero
        self.init_kwargs = {"min_size": min_size, "ndim": ndim, "ensure_zero": ensure_zero}

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        components = connected_components(labels, ndim=self.ndim, ensure_zero=self.ensure_zero)
        if self.min_size is not None:
            ids, sizes = np.unique(components, return_counts=True)
            filter_ids = ids[sizes < self.min_size]
            components[np.isin(components, filter_ids)] = 0
            components = ops.label_consecutive(components)
        return components


class BoundaryTransform:
    """Instance segmentation -> boundary target (torch-em label.py:100)."""

    def __init__(self, mode: str = "thick", add_binary_target: bool = False, ndim: Optional[int] = None):
        self.mode = mode
        self.add_binary_target = add_binary_target
        self.ndim = ndim
        self.init_kwargs = {"mode": mode, "add_binary_target": add_binary_target, "ndim": ndim}

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        labels = ensure_array(labels) if self.ndim is None else ensure_spatial_array(labels, self.ndim)
        boundaries = ops.find_boundaries(labels, mode=self.mode)[None]
        if self.add_binary_target:
            binary = labels_to_binary(labels)[None].astype(boundaries.dtype)
            return np.concatenate([binary, boundaries], axis=0)
        return boundaries


class NoToBackgroundBoundaryTransform:
    """Boundary target that masks object-background boundaries with a mask label
    (torch-em label.py:133)."""

    def __init__(self, bg_label: int = 0, mask_label: int = -1, mode: str = "thick",
                 add_binary_target: bool = False, ndim: Optional[int] = None):
        self.bg_label = bg_label
        self.mask_label = mask_label
        self.mode = mode
        self.ndim = ndim
        self.add_binary_target = add_binary_target
        self.init_kwargs = {
            "bg_label": bg_label, "mask_label": mask_label, "mode": mode,
            "add_binary_target": add_binary_target, "ndim": ndim,
        }

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        labels = ensure_array(labels) if self.ndim is None else ensure_spatial_array(labels, self.ndim)
        boundaries = ops.find_boundaries(labels, mode=self.mode)[None]
        labels_binary = labels != self.bg_label
        to_bg_boundaries = ops.find_boundaries(labels_binary, mode=self.mode)[None]
        boundaries = boundaries.astype(np.int8)
        boundaries[to_bg_boundaries] = self.mask_label
        if self.add_binary_target:
            binary = labels_to_binary(labels, self.bg_label).astype(boundaries.dtype)
            binary[labels == self.mask_label] = self.mask_label
            return np.concatenate([binary[None], boundaries], axis=0)
        return boundaries


class BoundaryTransformWithIgnoreLabel:
    """Boundary target that marks boundaries touching the ignore label
    (torch-em label.py:192)."""

    def __init__(self, ignore_label: int = -1, mode: str = "thick",
                 add_binary_target: bool = False, ndim: Optional[int] = None):
        self.ignore_label = ignore_label
        self.mode = mode
        self.ndim = ndim
        self.add_binary_target = add_binary_target
        self.init_kwargs = {
            "ignore_label": ignore_label, "mode": mode,
            "add_binary_target": add_binary_target, "ndim": ndim,
        }

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        labels = ensure_array(labels) if self.ndim is None else ensure_spatial_array(labels, self.ndim)
        boundaries = ops.find_boundaries(labels, mode=self.mode)[None]
        labels_ignore = labels == self.ignore_label
        to_ignore_boundaries = ops.find_boundaries(labels_ignore, mode=self.mode)[None]
        boundaries = boundaries.astype(np.int8)
        boundaries[to_ignore_boundaries] = self.ignore_label
        if self.add_binary_target:
            binary = labels_to_binary(labels).astype(boundaries.dtype)
            binary[labels == self.ignore_label] = self.ignore_label
            return np.concatenate([binary[None], boundaries], axis=0)
        return boundaries


class AffinityTransform:
    """Instance segmentation -> multi-offset (dis)affinity target
    (torch-em label.py:248).

    Uses the disaffinity convention for training (1 = repulsive / transition,
    0 = attractive), matching torch-em label.py:307. With ``add_mask`` the
    validity mask channels are appended after the affinity channels, so that
    ``target.C == 2 * pred.C`` as expected by ``ApplyAndRemoveMask``.
    """

    def __init__(self, offsets: List[List[int]], ignore_label: Optional[int] = None,
                 add_binary_target: bool = False, add_mask: bool = False,
                 include_ignore_transitions: bool = False):
        self.offsets = offsets
        self.ndim = len(offsets[0])
        assert self.ndim in (2, 3)
        self.ignore_label = ignore_label
        self.add_binary_target = add_binary_target
        self.add_mask = add_mask
        self.include_ignore_transitions = include_ignore_transitions
        self.init_kwargs = {
            "offsets": offsets, "ignore_label": ignore_label, "add_binary_target": add_binary_target,
            "add_mask": add_mask, "include_ignore_transitions": include_ignore_transitions,
        }

    def _add_ignore_transitions(self, affs, mask, labels):
        # transitions into the ignore region count as positive boundaries
        ignore_seg = (labels == self.ignore_label).astype(labels.dtype)
        ignore_transitions, invalid_mask = ops.compute_affinities(ignore_seg, self.offsets)
        invalid_mask = np.logical_not(invalid_mask.astype(bool))
        ignore_transitions = ignore_transitions == 0
        ignore_transitions[invalid_mask] = 0
        affs[ignore_transitions] = 1
        mask[ignore_transitions] = 1
        return affs, mask

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        dtype = "uint64"
        if np.dtype(labels.dtype) in (np.dtype("int16"), np.dtype("int32"), np.dtype("int64")):
            dtype = "int64"
        labels = ensure_spatial_array(labels, self.ndim, dtype=dtype)
        affs, mask = ops.compute_affinities(
            labels, self.offsets,
            have_ignore_label=self.ignore_label is not None,
            ignore_label=0 if self.ignore_label is None else self.ignore_label,
        )
        affs = 1.0 - affs  # disaffinity convention

        if self.ignore_label is not None and self.include_ignore_transitions:
            affs, mask = self._add_ignore_transitions(affs, mask, labels)

        if self.add_binary_target:
            binary = labels_to_binary(labels)[None].astype(affs.dtype)
            affs = np.concatenate([binary, affs], axis=0)

        if self.add_mask:
            if self.add_binary_target:
                if self.ignore_label is None:
                    mask_for_bin = np.ones((1,) + labels.shape, dtype=mask.dtype)
                else:
                    mask_for_bin = (labels != self.ignore_label)[None].astype(mask.dtype)
                mask = np.concatenate([mask_for_bin, mask], axis=0)
            affs = np.concatenate([affs, mask.astype(affs.dtype)], axis=0)
        return affs


class OneHotTransform:
    """Semantic segmentation -> one-hot channels (torch-em label.py:332)."""

    def __init__(self, class_ids: Optional[Union[int, Sequence[int]]] = None):
        self.class_ids = list(range(class_ids)) if isinstance(class_ids, int) else class_ids
        self.init_kwargs = {"class_ids": class_ids}

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        class_ids = np.unique(labels).tolist() if self.class_ids is None else self.class_ids
        one_hot = np.zeros((len(class_ids),) + labels.shape, dtype="float32")
        for i, class_id in enumerate(class_ids):
            one_hot[i][labels == class_id] = 1.0
        return one_hot


class DistanceTransform:
    """Distances to the foreground (torch-em label.py:358).

    Computes vector distances to the nearest foreground pixel (vigra
    vectorDistanceTransform semantics via scipy EDT) and optionally normalizes,
    clips, inverts, or applies a user function.
    """

    eps = 1e-7

    def __init__(self, distances: bool = True, directed_distances: bool = False, normalize: bool = True,
                 max_distance: Optional[float] = None, foreground_id: int = 1, invert: bool = False,
                 func: Optional[Callable] = None):
        if sum((distances, directed_distances)) == 0:
            raise ValueError("At least one of 'distances' or 'directed_distances' must be set to 'True'")
        self.directed_distances = directed_distances
        self.distances = distances
        self.normalize = normalize
        self.max_distance = max_distance
        self.foreground_id = foreground_id
        self.invert = invert
        self.func = func
        self.init_kwargs = {
            "distances": distances, "directed_distances": directed_distances, "normalize": normalize,
            "max_distance": max_distance, "foreground_id": foreground_id, "invert": invert, "func": func,
        }

    def _compute_distances(self, directed):
        distances = np.linalg.norm(directed, axis=0)
        if self.max_distance is not None:
            distances = np.clip(distances, 0, self.max_distance)
        if self.normalize:
            distances = distances / (distances.max() + self.eps)
        if self.invert:
            distances = distances.max() - distances
        if self.func is not None:
            distances = self.func(distances)
        return distances

    def _compute_directed_distances(self, directed):
        spatial = tuple(range(1, directed.ndim))
        if self.max_distance is not None:
            directed = np.clip(directed, -self.max_distance, self.max_distance)
        if self.normalize:
            directed = directed / (np.abs(directed).max(axis=spatial, keepdims=True) + self.eps)
        if self.invert:
            directed = directed.max(axis=spatial, keepdims=True) - directed
        if self.func is not None:
            directed = self.func(directed)
        return directed

    def _get_distances_for_empty_labels(self, labels):
        shape = labels.shape
        fill_value = 0.0 if self.invert else np.sqrt(np.linalg.norm(list(shape)) ** 2 / 2)
        return np.full((labels.ndim,) + shape, fill_value, dtype="float32")

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        distance_mask = (np.asarray(labels) == self.foreground_id).astype("uint32")
        if distance_mask.sum() == 0:
            directed = self._get_distances_for_empty_labels(np.asarray(labels))
        else:
            directed = ops.vector_distance_transform(distance_mask)
        if self.distances:
            distances = self._compute_distances(directed)
        if self.directed_distances:
            directed = self._compute_directed_distances(directed)
        if self.distances and self.directed_distances:
            return np.concatenate((distances[None], directed), axis=0)
        if self.distances:
            return distances
        return directed


class PerObjectDistanceTransform:
    """Per-object normalized center and boundary distances (torch-em label.py:454).

    Channel layout (channel-first): [foreground?] [center-distance?]
    [directed-distances (ndim)?] [boundary-distance?] [instances?], matching the
    torch-em's output convention for DistanceLoss training.
    """

    eps = 1e-7

    def __init__(self, distances: bool = True, boundary_distances: bool = True, directed_distances: bool = False,
                 foreground: bool = True, instances: bool = False, apply_label: bool = True,
                 correct_centers: bool = True, min_size: int = 0, distance_fill_value: float = 1.0,
                 sampling: Optional[Tuple[float, ...]] = None):
        if sum([distances, directed_distances, boundary_distances]) == 0:
            raise ValueError("At least one of distances or directed distances has to be passed.")
        self.distances = distances
        self.boundary_distances = boundary_distances
        self.directed_distances = directed_distances
        self.foreground = foreground
        self.instances = instances
        self.apply_label = apply_label
        self.correct_centers = correct_centers
        self.min_size = min_size
        self.distance_fill_value = distance_fill_value
        self.sampling = sampling
        self.init_kwargs = {
            "distances": distances, "boundary_distances": boundary_distances,
            "directed_distances": directed_distances, "foreground": foreground, "instances": instances,
            "apply_label": apply_label, "correct_centers": correct_centers, "min_size": min_size,
            "distance_fill_value": distance_fill_value, "sampling": sampling,
        }

    def _object_distances(self, mask, boundaries, bb, center, distances):
        cropped_mask = mask[bb]
        cropped_center = tuple(int(ce) - b.start for ce, b in zip(center, bb))

        # the centroid may fall outside the object; correct to the interior
        # point of maximal boundary distance in that case
        correct_center = self.correct_centers and not cropped_mask[cropped_center]

        boundary_distances = None
        max_dist_point = None
        if correct_center or self.boundary_distances:
            cropped_boundary_mask = boundaries[bb]
            boundary_distances = ops.distance_transform(cropped_boundary_mask, sampling=self.sampling)
            boundary_distances[~cropped_mask] = 0
            max_dist_point = np.unravel_index(np.argmax(boundary_distances), boundary_distances.shape)
        if correct_center:
            cropped_center = max_dist_point

        cropped_center_mask = np.zeros_like(cropped_mask, dtype="uint32")
        cropped_center_mask[cropped_center] = 1

        this_distances = None
        if self.distances or self.directed_distances:
            vec = ops.vector_distance_transform(cropped_center_mask, sampling=self.sampling)
            vec = np.moveaxis(vec, 0, -1)  # channel-last for per-object assembly
            if self.distances and self.directed_distances:
                undir = np.linalg.norm(vec, axis=-1, keepdims=True)
                this_distances = np.concatenate([undir, vec], axis=-1)
            elif self.distances:
                this_distances = np.linalg.norm(vec, axis=-1, keepdims=True)
            else:
                this_distances = vec

        if self.boundary_distances:
            bdist = (boundary_distances[max_dist_point] - boundary_distances)[..., None]
            this_distances = bdist if this_distances is None else np.concatenate([this_distances, bdist], axis=-1)

        this_distances[~cropped_mask] = 0
        spatial_axes = tuple(range(mask.ndim))
        this_distances = this_distances / (np.abs(this_distances).max(axis=spatial_axes, keepdims=True) + self.eps)
        distances[bb][cropped_mask] = this_distances[cropped_mask]
        return distances

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        labels = np.asarray(labels)
        if self.apply_label:
            labels = ops.connected_components(labels).astype("uint32")
        else:
            labels = ops.label_consecutive(labels).astype("uint32")

        if self.min_size > 0:
            ids, sizes = np.unique(labels, return_counts=True)
            discard_ids = ids[sizes < self.min_size]
            labels[np.isin(labels, discard_ids)] = 0
            labels = ops.label_consecutive(labels).astype("uint32")

        boundaries = ops.find_boundaries(labels, mode="inner").astype("uint32")
        ndim = labels.ndim
        bounding_boxes = ops.region_bounding_boxes(labels)
        label_ids = np.array(sorted(bounding_boxes.keys()))
        centroids = ops.region_centroids(labels, ids=label_ids) if len(label_ids) else np.zeros((0, ndim))
        centers = {int(i): np.round(c).astype("int") for i, c in zip(label_ids, centroids)}

        n_channels = int(self.distances) + int(self.boundary_distances) + (ndim if self.directed_distances else 0)
        distances = np.full(labels.shape + (n_channels,), self.distance_fill_value, dtype="float32")
        for label_id in label_ids:
            label_id = int(label_id)
            mask = labels == label_id
            distances = self._object_distances(
                mask, boundaries, bounding_boxes[label_id], centers[label_id], distances
            )

        to_channel_first = (ndim,) + tuple(range(ndim))
        distances = distances.transpose(to_channel_first)
        if self.foreground:
            binary_labels = (labels > 0).astype("float32")
            distances = np.concatenate([binary_labels[None], distances], axis=0)
        if self.instances:
            distances = np.concatenate([labels[None], distances], axis=0)
        return distances
