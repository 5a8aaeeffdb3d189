"""Raw-data (intensity) transforms on the host.

Counterpart of ``torch_em_tpu/transforms/raw.py``; this slice ports
``standardize``, the default preprocessing of tiled prediction.
"""

import numpy as np

__all__ = ["standardize"]


def standardize(raw, mean=None, std=None, axis=None, eps: float = 1e-7) -> np.ndarray:
    """Zero-mean / unit-std standardization."""
    raw = np.asarray(raw).astype("float32")
    mean = raw.mean(axis=axis, keepdims=True) if mean is None else mean
    raw = raw - mean
    std = raw.std(axis=axis, keepdims=True) if std is None else std
    raw = raw / (std + eps)
    return raw
