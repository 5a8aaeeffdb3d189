"""Grid search over the parameters of an instance-segmentation post-processing.

Counterpart of ``torch_em_tpu/utils/grid_search.py`` (torch-em's
``util/grid_search.py``). A segmenter has ``initialize(image)``, which
predicts (on the model's device) and keeps the prediction, and
``generate(**params)``, which decodes it with one parameter setting;
``instance_segmentation_grid_search`` scores every setting on every image
by the mean segmentation accuracy against its ground truth and returns the
best setting. The per-image tables ``<image name>.csv`` and
``best_params.csv`` have the JAX package's names, columns and values; they
are written with the ``csv`` module (the machine with the card has no
pandas). Images and ground truth are read with ``utils.io.load_data``, so
``.npy`` files work everywhere.
"""

import csv
import os
from itertools import product
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..metric.eval import matching
from .segmentation import watershed_from_center_and_boundary_distances, watershed_from_components

__all__ = [
    "default_grid_search_values_boundary_based_instance_segmentation",
    "BoundaryBasedInstanceSegmentation", "DistanceBasedInstanceSegmentation",
    "instance_segmentation_grid_search",
]


def default_grid_search_values_boundary_based_instance_segmentation(
    threshold1_values=None, threshold2_values=None, min_size_values=None,
) -> Dict[str, List]:
    """The default grid of ``BoundaryBasedInstanceSegmentation``."""
    if threshold1_values is None:
        threshold1_values = [0.5, 0.55, 0.6]
    if threshold2_values is None:
        threshold2_values = [0.5, 0.55, 0.6]
    if min_size_values is None:
        min_size_values = [25, 50, 75, 100, 200]
    return {"threshold1": threshold1_values, "threshold2": threshold2_values, "min_size": min_size_values}


class _InstanceSegmentationBase:
    """``initialize(image)`` predicts and keeps the prediction; ``generate(**params)`` decodes it."""

    def __init__(self, model, block_shape=None, halo=None):
        self.model = model
        self.block_shape = block_shape
        self.halo = halo
        self._prediction = None

    def _predict(self, image):
        from .prediction import predict_with_halo, predict_with_padding

        if self.block_shape is None:
            return predict_with_padding(self.model, image, min_divisible=(16,) * image.ndim)[0]
        return predict_with_halo(image, self.model, block_shape=self.block_shape, halo=self.halo, disable_tqdm=True)

    def initialize(self, image):
        self._prediction = self._predict(image)

    @property
    def is_initialized(self):
        return self._prediction is not None


class BoundaryBasedInstanceSegmentation(_InstanceSegmentationBase):
    """Decode (foreground, boundary) predictions with a seeded watershed."""

    def generate(self, min_size: int = 50, threshold1: float = 0.5, threshold2: float = 0.5):
        assert self.is_initialized
        foreground, boundaries = self._prediction[0], self._prediction[1]
        return watershed_from_components(
            boundaries, foreground, min_size=min_size, threshold1=threshold1, threshold2=threshold2)


class DistanceBasedInstanceSegmentation(_InstanceSegmentationBase):
    """Decode (foreground, center distance, boundary distance) predictions."""

    def generate(self, center_distance_threshold: float = 0.5, boundary_distance_threshold: float = 0.5,
                 foreground_threshold: float = 0.5, distance_smoothing: float = 1.6, min_size: int = 0):
        assert self.is_initialized
        fg, cdist, bdist = self._prediction[0], self._prediction[1], self._prediction[2]
        return watershed_from_center_and_boundary_distances(
            cdist, bdist, fg, center_distance_threshold=center_distance_threshold,
            boundary_distance_threshold=boundary_distance_threshold, foreground_threshold=foreground_threshold,
            distance_smoothing=distance_smoothing, min_size=min_size)


def _cell(value):
    """A table value as pandas' ``to_csv`` writes it: numpy scalars as Python numbers."""
    return value.item() if isinstance(value, np.generic) else value


def _write_table(path, rows):
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows([{k: _cell(v) for k, v in row.items()} for row in rows])


def instance_segmentation_grid_search(
    segmenter,
    image_paths: List[str],
    gt_paths: List[str],
    result_dir: str,
    grid_search_values: Dict[str, List],
    rois: Optional[List[Tuple]] = None,
    image_key: Optional[str] = None,
    gt_key: Optional[str] = None,
) -> Tuple[Dict, float]:
    """Score every setting of ``grid_search_values`` on every image; returns (best_params,
    best_score), the setting with the highest mean segmentation accuracy and that mean.
    Writes one table per image and ``best_params.csv`` to ``result_dir``."""
    from .io import load_data

    assert len(image_paths) == len(gt_paths)
    os.makedirs(result_dir, exist_ok=True)

    param_names = list(grid_search_values.keys())
    combinations = [dict(zip(param_names, vals)) for vals in product(*grid_search_values.values())]

    all_scores = np.zeros((len(image_paths), len(combinations)))
    for i, (im_path, gt_path) in enumerate(zip(image_paths, gt_paths)):
        image = np.asarray(load_data(im_path, image_key)[:])
        gt = np.asarray(load_data(gt_path, gt_key)[:])
        if rois is not None:
            image, gt = image[rois[i]], gt[rois[i]]
        segmenter.initialize(image)
        rows = []
        for j, params in enumerate(combinations):
            seg = segmenter.generate(**params)
            score = matching(seg, gt)["accuracy"]  # mean segmentation accuracy
            all_scores[i, j] = score
            rows.append({**params, "score": score})
        _write_table(os.path.join(result_dir, f"{os.path.splitext(os.path.basename(im_path))[0]}.csv"), rows)

    mean_scores = all_scores.mean(axis=0)
    best_idx = int(np.argmax(mean_scores))
    best_params = combinations[best_idx]
    best_score = float(mean_scores[best_idx])
    _write_table(os.path.join(result_dir, "best_params.csv"), [{**best_params, "score": best_score}])
    return best_params, best_score
