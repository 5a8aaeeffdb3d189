"""Rejection-sampling criteria for ``SegmentationDataset``.

The port's own copy of ``torch_em_tpu/data/sampler.py`` (after torch-em's
``data/sampler.py``). A sampler is ``callable(raw[, labels]) -> bool``; a
sample that fails the criterion is still accepted with probability
``1 - p_reject``, drawn from the global ``np.random`` as in the JAX package,
so the same seed gives the same decisions.
"""

from typing import Callable, List, Optional, Union

import numpy as np

__all__ = [
    "MinForegroundSampler", "MinSemanticLabelForegroundSampler", "MinIntensitySampler",
    "MinInstanceSampler", "MinTwoInstanceSampler", "MinNoToBackgroundBoundarySampler",
]


class MinForegroundSampler:
    """Reject samples with a low foreground fraction (torch-em sampler.py:5)."""

    def __init__(self, min_fraction: float, background_id: Union[int, List[int]] = 0, p_reject: float = 1.0):
        self.min_fraction = min_fraction
        self.background_id = background_id
        self.p_reject = p_reject
        self.init_kwargs = {"min_fraction": min_fraction, "background_id": background_id, "p_reject": p_reject}

    def __call__(self, x: np.ndarray, y: Optional[np.ndarray] = None) -> bool:
        if y is None:
            y = x
        size = float(y.size)
        if isinstance(self.background_id, int):
            foreground_fraction = np.sum(y != self.background_id) / size
        else:
            foreground_fraction = np.sum(np.logical_not(np.isin(y, self.background_id))) / size
        if foreground_fraction > self.min_fraction:
            return True
        return np.random.rand() > self.p_reject


class MinSemanticLabelForegroundSampler:
    """Reject samples with low semantic-class coverage (torch-em sampler.py:45)."""

    def __init__(self, semantic_ids: List[int], min_fraction: float,
                 min_fraction_per_id: bool = False, p_reject: float = 1.0):
        self.semantic_ids = semantic_ids
        self.min_fraction = min_fraction
        self.p_reject = p_reject
        self.min_fraction_per_id = min_fraction_per_id
        self.init_kwargs = {
            "semantic_ids": semantic_ids, "min_fraction": min_fraction,
            "min_fraction_per_id": min_fraction_per_id, "p_reject": p_reject,
        }

    def __call__(self, x: np.ndarray, y: np.ndarray) -> bool:
        size = float(y.size)
        if self.min_fraction_per_id:
            foreground_fraction = [np.sum(np.isin(y, idx)) / size for idx in self.semantic_ids]
        else:
            foreground_fraction = [np.sum(np.isin(y, self.semantic_ids)) / size]
        if all(fraction > self.min_fraction for fraction in foreground_fraction):
            return True
        return np.random.rand() > self.p_reject


class MinIntensitySampler:
    """Reject samples with low raw intensity (torch-em sampler.py:85)."""

    def __init__(self, min_intensity: float, function: Union[str, Callable] = "median", p_reject: float = 1.0):
        self.min_intensity = min_intensity
        self.function = getattr(np, function) if isinstance(function, str) else function
        assert callable(self.function)
        self.p_reject = p_reject
        self.init_kwargs = {"min_intensity": min_intensity, "function": function, "p_reject": p_reject}

    def __call__(self, x: np.ndarray, y: Optional[np.ndarray] = None) -> bool:
        intensity = self.function(x)
        if intensity > self.min_intensity:
            return True
        return np.random.rand() > self.p_reject


class MinInstanceSampler:
    """Reject samples with too few instances (torch-em sampler.py:118)."""

    def __init__(self, min_num_instances: int = 2, p_reject: float = 1.0,
                 min_size: Optional[int] = None, exclude_ids: Optional[List[int]] = None):
        self.min_num_instances = min_num_instances
        self.p_reject = p_reject
        self.min_size = min_size
        self.exclude_ids = exclude_ids
        if self.exclude_ids is not None:
            assert isinstance(self.exclude_ids, list)
        self.init_kwargs = {
            "min_num_instances": min_num_instances, "p_reject": p_reject,
            "min_size": min_size, "exclude_ids": exclude_ids,
        }

    def __call__(self, x: np.ndarray, y: np.ndarray) -> bool:
        uniques, sizes = np.unique(y, return_counts=True)
        if self.min_size is not None:
            uniques = uniques[sizes >= self.min_size]
        if self.exclude_ids is not None:
            uniques = [idx for idx in uniques if idx not in self.exclude_ids]
        if len(uniques) >= self.min_num_instances:
            return True
        return np.random.rand() > self.p_reject


class MinTwoInstanceSampler:
    """Fast >=2-instances check without np.unique (torch-em sampler.py:167)."""

    def __init__(self, p_reject: float = 1.0):
        self.p_reject = p_reject
        self.init_kwargs = {"p_reject": p_reject}

    def __call__(self, x: np.ndarray, y: np.ndarray) -> bool:
        sample_value = y.flat[0]
        if (y != sample_value).any():
            return True
        return np.random.rand() > self.p_reject


class MinNoToBackgroundBoundarySampler:
    """Reject samples without no-to-background boundaries (torch-em sampler.py:201)."""

    def __init__(self, trafo, min_fraction: float = 0.01, p_reject: float = 1.0):
        self.trafo = trafo
        self.bg_label = trafo.bg_label
        self.mask_label = trafo.mask_label
        self.min_fraction = min_fraction
        self.p_reject = p_reject
        self.init_kwargs = {"trafo": trafo, "min_fraction": min_fraction, "p_reject": p_reject}

    def __call__(self, x: np.ndarray, y: np.ndarray) -> bool:
        y_boundaries = self.trafo(y)
        y_boundaries[y_boundaries == self.mask_label] = self.bg_label
        size = float(y_boundaries.size)
        foreground_fraction = np.sum(y_boundaries != self.bg_label) / size
        if foreground_fraction > self.min_fraction:
            return True
        return np.random.rand() > self.p_reject
