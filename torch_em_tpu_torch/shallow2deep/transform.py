"""Label transforms that make random-forest targets.

The port's own copy of ``torch_em_tpu/shallow2deep/transform.py`` (after
torch-em's ``shallow2deep/transform.py``): -1 marks pixels to ignore, class
ids count from 0.
"""

from typing import Optional

import numpy as np
from scipy import ndimage

from ..ops import host as ops
from ..utils.tensor import ensure_array, ensure_spatial_array

__all__ = ["ForegroundTransform", "BoundaryTransform"]


class ForegroundTransform:
    """Foreground (1) against background (0), ignoring the background within
    ``ignore_radius`` of the foreground."""

    def __init__(self, label_id: Optional[int] = None, ndim: Optional[int] = None, ignore_radius: int = 1):
        self.label_id = label_id
        self.ndim = ndim
        self.ignore_radius = ignore_radius
        self.init_kwargs = {"label_id": label_id, "ndim": ndim, "ignore_radius": ignore_radius}

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        labels = ensure_array(labels) if self.ndim is None else ensure_spatial_array(labels, self.ndim)
        target = (labels != 0) if self.label_id is None else (labels == self.label_id)
        target = target.astype("int8")
        if self.ignore_radius > 0:
            dist = ndimage.distance_transform_edt(target == 0)
            target[np.logical_and(dist <= self.ignore_radius, dist > 0)] = -1
        return target[None]


class BoundaryTransform:
    """Boundaries (2), foreground (1) and background (0), or boundaries alone without
    ``add_binary_target``; pixels within ``ignore_radius`` of a boundary are ignored."""

    def __init__(self, mode: str = "thick", add_binary_target: bool = True, ndim: Optional[int] = None,
                 ignore_radius: int = 2):
        self.mode = mode
        self.add_binary_target = add_binary_target
        self.ndim = ndim
        self.ignore_radius = ignore_radius
        self.init_kwargs = {"mode": mode, "add_binary_target": add_binary_target, "ndim": ndim,
                            "ignore_radius": ignore_radius}

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        labels = ensure_array(labels) if self.ndim is None else ensure_spatial_array(labels, self.ndim)
        boundaries = ops.find_boundaries(labels, mode=self.mode)
        if self.add_binary_target:
            target = (labels != 0).astype("int8")
            target[boundaries] = 2
        else:
            target = boundaries.astype("int8")
        if self.ignore_radius > 0:
            dist = ndimage.distance_transform_edt(~boundaries)
            target[np.logical_and(dist <= self.ignore_radius, dist > 0)] = -1
        return target[None]
