"""Filter bank for random-forest features.

The port's own copy of ``torch_em_tpu/shallow2deep/filters.py``, which
stands in for the vigra/fastfilters bank of torch-em's Shallow2Deep with
scipy: gaussian smoothing, Laplacian of Gaussian, gaussian gradient
magnitude, Hessian-of-Gaussian eigenvalues and structure-tensor eigenvalues.
Multi-channel responses are channels-last (vigra's convention). They run on
the host.
"""

from itertools import combinations_with_replacement

import numpy as np
from scipy import ndimage

__all__ = [
    "gaussianSmoothing", "laplacianOfGaussian", "gaussianGradientMagnitude",
    "hessianOfGaussianEigenvalues", "structureTensorEigenvalues",
]


def gaussianSmoothing(raw, sigma):
    return ndimage.gaussian_filter(raw.astype("float32"), sigma)


def laplacianOfGaussian(raw, sigma):
    return ndimage.gaussian_laplace(raw.astype("float32"), sigma)


def gaussianGradientMagnitude(raw, sigma):
    return ndimage.gaussian_gradient_magnitude(raw.astype("float32"), sigma)


def _sym_eigenvalues(matrix_entries, ndim, shape):
    """Eigenvalues, in descending order, of per-pixel symmetric matrices given by their upper
    triangle (ordered as ``combinations_with_replacement``)."""
    mat = np.zeros(shape + (ndim, ndim), dtype="float32")
    for (i, j), entry in zip(combinations_with_replacement(range(ndim), 2), matrix_entries):
        mat[..., i, j] = entry
        mat[..., j, i] = entry
    return np.linalg.eigvalsh(mat)[..., ::-1]


def hessianOfGaussianEigenvalues(raw, sigma):
    raw = raw.astype("float32")
    ndim = raw.ndim
    entries = []
    for i, j in combinations_with_replacement(range(ndim), 2):
        order = [0] * ndim
        order[i] += 1
        order[j] += 1
        entries.append(ndimage.gaussian_filter(raw, sigma, order=order))
    return _sym_eigenvalues(entries, ndim, raw.shape)


def structureTensorEigenvalues(raw, sigma, outerScale=None):
    raw = raw.astype("float32")
    ndim = raw.ndim
    if outerScale is None:
        outerScale = 2 * sigma if not isinstance(sigma, tuple) else tuple(2 * s for s in sigma)
    grads = [ndimage.gaussian_filter(raw, sigma, order=tuple(int(d == ax) for d in range(ndim)))
             for ax in range(ndim)]
    entries = [
        ndimage.gaussian_filter(grads[i] * grads[j], outerScale)
        for i, j in combinations_with_replacement(range(ndim), 2)
    ]
    return _sym_eigenvalues(entries, ndim, raw.shape)
