"""Raw-data (intensity) transforms on the host (numpy and scipy).

The port's own copy of ``torch_em_tpu/transforms/raw.py`` (after torch-em's
``transform/raw.py``): ``standardize``, ``normalize``,
``normalize_percentile``, the contrast, noise and blur augmentations (drawn
from the global ``np.random``, so the same seed gives the JAX package's
draws), ``Compose``, ``RandomApply``, ``RawTransform``, ``get_raw_transform``
and ``get_default_mean_teacher_augmentations``. They run per sample in the
loader's threads; the geometric augmentations are in
:mod:`torch_em_tpu_torch.transforms.augmentation`.
"""

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
from scipy import ndimage

__all__ = [
    "standardize", "normalize", "normalize_percentile", "RandomContrast",
    "AdditiveGaussianNoise", "AdditivePoissonNoise", "PoissonNoise",
    "GaussianBlur", "RawTransform", "get_raw_transform", "Compose",
    "RandomApply", "get_default_mean_teacher_augmentations",
]


def standardize(raw, mean=None, std=None, axis=None, eps: float = 1e-7) -> np.ndarray:
    """Zero-mean / unit-std standardization (torch-em transform/raw.py:40)."""
    raw = np.asarray(raw).astype("float32")
    mean = raw.mean(axis=axis, keepdims=True) if mean is None else mean
    raw = raw - mean
    std = raw.std(axis=axis, keepdims=True) if std is None else std
    raw = raw / (std + eps)
    return raw


def normalize(raw, minval=None, maxval=None, axis=None, eps: float = 1e-7) -> np.ndarray:
    """Min-max normalization to [0, 1] (torch-em transform/raw.py:88)."""
    raw = np.asarray(raw).astype("float32")
    minval = raw.min(axis=axis, keepdims=True) if minval is None else minval
    raw = raw - minval
    maxval = raw.max(axis=axis, keepdims=True) if maxval is None else maxval
    raw = raw / (maxval + eps)
    return raw


def normalize_percentile(raw, lower: float = 1.0, upper: float = 99.0, axis=None, eps: float = 1e-7) -> np.ndarray:
    """Percentile normalization (torch-em transform/raw.py:119)."""
    raw = np.asarray(raw)
    v_lower = np.percentile(raw, lower, axis=axis, keepdims=True)
    v_upper = np.percentile(raw, upper, axis=axis, keepdims=True) - v_lower
    return normalize(raw, v_lower, v_upper, eps=eps)


class RandomContrast:
    """Contrast jitter: ``mean + alpha * (img - mean)`` with uniform alpha
    (torch-em transform/raw.py:148)."""

    def __init__(
        self, alpha: Tuple[float, float] = (0.5, 2), mean: float = 0.5,
        clip_kwargs: Union[Dict, bool] = {"a_min": 0, "a_max": 1},
    ):
        self.alpha = alpha
        self.mean = mean
        self.clip_kwargs = clip_kwargs
        self.init_kwargs = {"alpha": alpha, "mean": mean, "clip_kwargs": clip_kwargs}

    def __call__(self, img: np.ndarray) -> np.ndarray:
        alpha = np.random.uniform(self.alpha[0], self.alpha[1])
        result = self.mean + alpha * (img - self.mean)
        if self.clip_kwargs:
            return np.clip(result, **self.clip_kwargs)
        return result


class AdditiveGaussianNoise:
    """Additive Gaussian noise with uniformly sampled std (torch-em raw.py:180)."""

    def __init__(self, scale: Tuple[float, float] = (0.0, 0.3), clip_kwargs={"a_min": 0, "a_max": 1}):
        self.scale = scale
        self.clip_kwargs = clip_kwargs
        self.init_kwargs = {"scale": scale, "clip_kwargs": clip_kwargs}

    def __call__(self, img: np.ndarray) -> np.ndarray:
        std = np.random.uniform(self.scale[0], self.scale[1])
        noise = np.random.normal(0, std, size=np.shape(img)).astype("float32")
        out = img + noise
        if self.clip_kwargs:
            return np.clip(out, **self.clip_kwargs)
        return out


class AdditivePoissonNoise:
    """Additive Poisson noise (torch-em raw.py:209)."""

    def __init__(self, lam: Tuple[float, float] = (0.0, 0.1), clip_kwargs={"a_min": 0, "a_max": 1}):
        self.lam = lam
        self.clip_kwargs = clip_kwargs
        self.init_kwargs = {"lam": lam, "clip_kwargs": clip_kwargs}

    def __call__(self, img: np.ndarray) -> np.ndarray:
        lam = np.random.uniform(self.lam[0], self.lam[1])
        noise = np.random.poisson(lam, size=np.shape(img)) / max(lam, 1e-7)
        out = img + noise.astype("float32")
        if self.clip_kwargs:
            return np.clip(out, **self.clip_kwargs)
        return out


class PoissonNoise:
    """Data-dependent Poisson noise (torch-em raw.py:237)."""

    def __init__(self, multiplier: Tuple[float, float] = (5.0, 10.0), clip_kwargs={"a_min": 0, "a_max": 1}):
        self.multiplier = multiplier
        self.clip_kwargs = clip_kwargs
        self.init_kwargs = {"multiplier": multiplier, "clip_kwargs": clip_kwargs}

    def __call__(self, img: np.ndarray) -> np.ndarray:
        multiplier = np.random.uniform(self.multiplier[0], self.multiplier[1])
        offset = img.min()
        noise = np.random.poisson(np.clip((img - offset), 0, None) * multiplier)
        out = noise.astype("float32") / multiplier + offset
        if self.clip_kwargs:
            return np.clip(out, **self.clip_kwargs)
        return out


class GaussianBlur:
    """Gaussian blur with uniformly sampled sigma (torch-em raw.py:271);
    uses scipy's separable gaussian filter instead of torchvision."""

    def __init__(self, sigma: Tuple[float, float] = (0.0, 3.0)):
        self.sigma = sigma
        self.init_kwargs = {"sigma": sigma}

    def __call__(self, img: np.ndarray) -> np.ndarray:
        sigma = np.random.uniform(self.sigma[0], self.sigma[1])
        if sigma <= 0:
            return img
        return ndimage.gaussian_filter(np.asarray(img, dtype="float32"), sigma=sigma)


class Compose:
    """Sequential composition of callables (stand-in for torchvision Compose)."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)
        self.init_kwargs = {"transforms": self.transforms}

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class RandomApply:
    """Apply the wrapped transforms with probability ``p``
    (stand-in for torchvision RandomApply)."""

    def __init__(self, transforms: Sequence[Callable], p: float = 0.5):
        if callable(transforms):
            transforms = [transforms]
        self.transforms = list(transforms)
        self.p = p
        self.init_kwargs = {"transforms": self.transforms, "p": p}

    def __call__(self, x):
        if np.random.rand() < self.p:
            for t in self.transforms:
                x = t(x)
        return x


class RawTransform:
    """aug1 -> normalize -> aug2 composition (torch-em raw.py:304)."""

    def __init__(self, normalizer: Callable, augmentation1: Optional[Callable] = None,
                 augmentation2: Optional[Callable] = None):
        self.normalizer = normalizer
        self.augmentation1 = augmentation1
        self.augmentation2 = augmentation2
        self.init_kwargs = {
            "normalizer": normalizer, "augmentation1": augmentation1, "augmentation2": augmentation2,
        }

    def __call__(self, raw: np.ndarray) -> np.ndarray:
        if self.augmentation1 is not None:
            raw = self.augmentation1(raw)
        raw = self.normalizer(raw)
        if self.augmentation2 is not None:
            raw = self.augmentation2(raw)
        return raw


def get_raw_transform(normalizer: Callable = standardize, augmentation1: Optional[Callable] = None,
                      augmentation2: Optional[Callable] = None) -> Callable:
    """Default raw transformation factory (torch-em raw.py:338)."""
    return RawTransform(normalizer, augmentation1=augmentation1, augmentation2=augmentation2)


def get_default_mean_teacher_augmentations(
    p: float = 0.3,
    norm: Optional[Callable] = None,
    blur_kwargs: Optional[Dict] = None,
    poisson_kwargs: Optional[Dict] = None,
    gaussian_kwargs: Optional[Dict] = None,
) -> Callable:
    """Default intensity augmentations for mean-teacher style training
    (torch-em raw.py:356)."""
    if norm is None:
        norm = normalize
    aug1 = Compose([
        norm,
        RandomApply([GaussianBlur(**(blur_kwargs or {}))], p=p),
        RandomApply([PoissonNoise(**(poisson_kwargs or {}))], p=p / 2),
        RandomApply([AdditiveGaussianNoise(**(gaussian_kwargs or {}))], p=p / 2),
    ])
    aug2 = RandomApply([RandomContrast(clip_kwargs={"a_min": 0, "a_max": 1})], p=p)
    return get_raw_transform(normalizer=norm, augmentation1=aug1, augmentation2=aug2)
