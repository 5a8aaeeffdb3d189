"""Invertible augmentations for consistency training.

Counterpart of ``torch_em_tpu/transforms/invertible_augmentations.py``
(torch-em's ``transform/invertible_augmentations.py``): weak and strong
augmenters that warp a batch and inverse-warp a prediction, and the
MeanTeacher, FixMatch and UniMatch v2 bundles.

One set of parameters serves the whole batch, as the JAX package draws each
flag, ``k``, the blur's sigma and the apply decisions once per call; only
the Gaussian noise has the input's shape. Drawing and applying are apart:
``draw`` takes the scalars from a CPU ``torch.Generator`` (``torch.rot90``
needs a Python ``k``, and a draw on the card would make each step wait for
it) and the noise from a generator on the input's device; ``apply`` and
``inverse`` take given parameters, so a test can feed the ones that JAX drew.
The geometric operations act on the trailing two axes, which covers 2D
batches (B, C, H, W) and per-slice 3D (B, C, D, H, W). The rotation needs a
square patch: the JAX package's ``lax.switch`` over ``k`` needs equal shapes
in every branch, and so works on square patches only.
"""

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "InvertibleAugmenter", "MeanTeacherAugmenters", "FixMatchAugmenters", "UniMatchv2Augmenters",
    "DEFAULT_WEAK_AUGMENTATIONS", "DEFAULT_STRONG_AUGMENTATIONS", "gaussian_blur3",
]

DEFAULT_WEAK_AUGMENTATIONS = {
    "intensity": {},
    "geometrical": {"RandomHorizontalFlip": {}, "RandomVerticalFlip": {}, "RandomRotation90": {"times": (-1, 2)}},
}
DEFAULT_STRONG_AUGMENTATIONS = {
    "intensity": {
        "RandomGaussianBlur": {"kernel_size": (3, 3), "sigma": (0.1, 1.0)},
        "RandomGaussianNoise": {"mean": 0.0, "std": 0.1},
    },
    "geometrical": {"RandomHorizontalFlip": {}, "RandomVerticalFlip": {}, "RandomRotation90": {"times": (-1, 2)}},
}


def gaussian_blur3(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """3-tap separable Gaussian blur of the trailing two axes with edge padding, the rows first;
    sigma is clamped at 1e-3 and the taps are computed in float32, as the JAX package's."""
    t = torch.tensor([-1.0, 0.0, 1.0])
    kernel = torch.exp(-0.5 * (t / max(float(np.float32(sigma)), 1e-3)) ** 2)
    k0, k1, k2 = (kernel / kernel.sum()).tolist()

    def blur_last(a):
        padded = torch.cat([a[..., :1], a, a[..., -1:]], dim=-1)
        return padded[..., :-2] * k0 + padded[..., 1:-1] * k1 + padded[..., 2:] * k2

    return blur_last(blur_last(x).transpose(-1, -2)).transpose(-1, -2)


def _check_square(x: torch.Tensor):
    if x.ndim < 2 or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"The invertible augmentations rotate the trailing two axes and need them square, "
                         f"got shape {tuple(x.shape)}")


class InvertibleAugmenter:
    """Weak (flips, rot90) or strong (blur and noise, then flips and rot90) invertible augmenter.

    ``forward(x, generator, noise_generator)`` returns the warped batch and its parameters,
    ``inverse(pred, params)`` undoes the geometric part. The reference's stateful API,
    ``transform(x)`` then ``reverse_transform(pred)``, draws from the augmenter's own
    generator, seeded ``seed``.
    """

    def __init__(self, kind: str = "weak", p: float = 0.75, times: Tuple[int, int] = (-1, 2),
                 blur_sigma: Tuple[float, float] = (0.1, 1.0), noise_std: float = 0.1, seed: int = 0):
        if kind not in ("weak", "strong"):
            raise ValueError(f"kind must be 'weak' or 'strong', got {kind!r}")
        self.kind = kind
        self.p = p
        self.times = tuple(times)
        self.blur_sigma = tuple(blur_sigma)
        self.noise_std = noise_std
        self.params = None
        self.generator = torch.Generator().manual_seed(seed)
        self.init_kwargs = {"kind": kind, "p": p, "times": self.times, "blur_sigma": self.blur_sigma,
                            "noise_std": noise_std, "seed": seed}

    def draw(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
             noise_generator: Optional[torch.Generator] = None) -> dict:
        """Parameters for the batch ``x``: the scalars from ``generator`` (a CPU generator; the
        augmenter's own when None), the noise on ``x``'s device from ``noise_generator`` (when
        None, from a generator there seeded by one more draw of ``generator``). ``sigma`` and
        ``noise`` are None where the blur or the noise is not applied."""
        generator = self.generator if generator is None else generator
        u = torch.rand(7, generator=generator, dtype=torch.float64).tolist()
        lo, hi = self.times
        params = {"hflip": u[3] < self.p, "vflip": u[4] < self.p,
                  "k": min(lo + int(u[6] * (hi - lo + 1)), hi) if u[5] < self.p else 0}
        if self.kind == "strong":
            params["sigma"] = self.blur_sigma[0] + (self.blur_sigma[1] - self.blur_sigma[0]) * u[0] \
                if u[1] < self.p else None
            noise = None
            if u[2] < self.p:
                if noise_generator is None:
                    seed = int(torch.randint(2 ** 62, (1,), generator=generator))
                    noise_generator = torch.Generator(x.device).manual_seed(seed)
                noise = torch.randn(x.shape, generator=noise_generator, device=x.device, dtype=x.dtype) * self.noise_std
            params["noise"] = noise
        return params

    def apply(self, x: torch.Tensor, params: dict) -> torch.Tensor:
        """Blur, then noise (a strong augmenter's, where drawn), then the flips, then rot90."""
        _check_square(x)
        if params.get("sigma") is not None:
            x = gaussian_blur3(x, params["sigma"])
        if params.get("noise") is not None:
            x = x + params["noise"]
        if params["hflip"]:
            x = torch.flip(x, dims=(-1,))
        if params["vflip"]:
            x = torch.flip(x, dims=(-2,))
        return torch.rot90(x, params["k"], dims=(x.ndim - 2, x.ndim - 1)) if params["k"] % 4 else x

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None):
        params = self.draw(x, generator, noise_generator)
        return self.apply(x, params), params

    def inverse(self, pred: torch.Tensor, params: dict) -> torch.Tensor:
        """Undo the rotation, then the vertical flip, then the horizontal one."""
        _check_square(pred)
        if params["k"] % 4:
            pred = torch.rot90(pred, -params["k"], dims=(pred.ndim - 2, pred.ndim - 1))
        if params["vflip"]:
            pred = torch.flip(pred, dims=(-2,))
        if params["hflip"]:
            pred = torch.flip(pred, dims=(-1,))
        return pred

    # the reference's stateful API
    def reset(self):
        self.params = None

    def transform(self, x):
        out, self.params = self.forward(torch.as_tensor(x))
        return out

    def reverse_transform(self, x):
        if self.params is None:
            raise RuntimeError("Call transform before reverse_transform.")
        return self.inverse(torch.as_tensor(x), self.params)


class MeanTeacherAugmenters:
    """Weak teacher and weak student augmenters; ``forward`` and ``inverse`` warp the student's view."""

    def __init__(self, ndim: int, teacher: Optional[InvertibleAugmenter] = None,
                 student: Optional[InvertibleAugmenter] = None):
        self.ndim = ndim
        self.teacher = teacher or InvertibleAugmenter("weak")
        self.student = student or InvertibleAugmenter("weak")
        self.init_kwargs = {"ndim": ndim, "teacher": teacher, "student": student}

    def reset_all(self):
        self.teacher.reset()
        self.student.reset()

    def forward(self, x, generator=None, noise_generator=None):
        return self.student.forward(x, generator, noise_generator)

    def inverse(self, pred, params):
        return self.student.inverse(pred, params)


class FixMatchAugmenters(MeanTeacherAugmenters):
    """Weak teacher and strong student augmenters."""

    def __init__(self, ndim: int, teacher: Optional[InvertibleAugmenter] = None,
                 student: Optional[InvertibleAugmenter] = None):
        super().__init__(ndim, teacher or InvertibleAugmenter("weak"), student or InvertibleAugmenter("strong"))
        self.init_kwargs = {"ndim": ndim, "teacher": teacher, "student": student}


class UniMatchv2Augmenters:
    """One weak and two strong views."""

    def __init__(self, ndim: int, weak: Optional[InvertibleAugmenter] = None,
                 strong1: Optional[InvertibleAugmenter] = None, strong2: Optional[InvertibleAugmenter] = None):
        self.ndim = ndim
        self.weak = weak or InvertibleAugmenter("weak")
        self.strong1 = strong1 or InvertibleAugmenter("strong")
        self.strong2 = strong2 or InvertibleAugmenter("strong")
        self.init_kwargs = {"ndim": ndim, "weak": weak, "strong1": strong1, "strong2": strong2}

    def reset_all(self):
        self.weak.reset()
        self.strong1.reset()
        self.strong2.reset()
