"""clDice: topology-preserving loss for tubular structures.

The port's counterpart of the JAX package's ``loss/cldice.py`` (torch-em's
``loss/cldice.py``): ``SoftSkeletonize`` (iterative min/max-pool
morphology), ``cldice_score``, ``SoftclDiceLoss`` and
``CombinedclDiceLoss``. From arXiv:2003.07311. The pooling is max pooling
with stride 1 and implicit -inf padding of (window - 1) // 2 per side, which
is what the JAX package's ``reduce_window`` with SAME padding computes.
"""

import torch
import torch.nn.functional as F

from .dice import dice_score

__all__ = ["SoftSkeletonize", "cldice_score", "SoftclDiceLoss", "CombinedclDiceLoss"]


def _max_pool(x: torch.Tensor, window) -> torch.Tensor:
    """Max pooling with stride 1 and SAME padding over the trailing spatial dims of (N, C, *spatial)."""
    pool = F.max_pool2d if len(window) == 2 else F.max_pool3d
    return pool(x, kernel_size=tuple(window), stride=1, padding=tuple((w - 1) // 2 for w in window))


class SoftSkeletonize:
    """Differentiable skeletonization via iterated soft erosion/dilation."""

    def __init__(self, num_iter: int = 5):
        self.num_iter = num_iter
        self.init_kwargs = {"num_iter": num_iter}

    def soft_erode(self, x):
        if x.ndim == 4:
            p1 = -_max_pool(-x, (3, 1))
            p2 = -_max_pool(-x, (1, 3))
            return torch.minimum(p1, p2)
        elif x.ndim == 5:
            p1 = -_max_pool(-x, (3, 1, 1))
            p2 = -_max_pool(-x, (1, 3, 1))
            p3 = -_max_pool(-x, (1, 1, 3))
            return torch.minimum(torch.minimum(p1, p2), p3)
        raise ValueError(f"Expect 4d or 5d input, got {x.ndim}d")

    def soft_dilate(self, x):
        if x.ndim == 4:
            return _max_pool(x, (3, 3))
        elif x.ndim == 5:
            return _max_pool(x, (3, 3, 3))
        raise ValueError(f"Expect 4d or 5d input, got {x.ndim}d")

    def soft_open(self, x):
        return self.soft_dilate(self.soft_erode(x))

    def soft_skel(self, x):
        x1 = self.soft_open(x)
        skel = F.relu(x - x1)
        for _ in range(self.num_iter):
            x = self.soft_erode(x)
            x1 = self.soft_open(x)
            delta = F.relu(x - x1)
            skel = skel + F.relu(delta - skel * delta)
        return skel

    def __call__(self, x):
        return self.soft_skel(x)


def cldice_score(input_, target, num_iter: int = 5, invert: bool = False, eps: float = 1e-7):
    """Soft clDice score (reference cldice.py:73)."""
    if input_.shape != target.shape:
        raise ValueError(f"Expect input and target of same shape, got: {input_.shape}, {target.shape}.")
    soft_skeletonize = SoftSkeletonize(num_iter=num_iter)
    skel_input = soft_skeletonize(input_)
    skel_target = soft_skeletonize(target)
    t_prec = (skel_input * target).sum() / skel_input.sum().clamp(min=eps)
    t_sens = (skel_target * input_).sum() / skel_target.sum().clamp(min=eps)
    score = 2.0 * (t_prec * t_sens) / (t_prec + t_sens).clamp(min=eps)
    if invert:
        score = 1.0 - score
    return score


class SoftclDiceLoss:
    """Soft clDice loss (reference cldice.py:111)."""

    def __init__(self, num_iter: int = 5, eps: float = 1e-7, exclude_background: bool = False):
        self.num_iter = num_iter
        self.eps = eps
        self.exclude_background = exclude_background
        self.init_kwargs = {"num_iter": num_iter, "eps": eps, "exclude_background": exclude_background}

    def __call__(self, input_, target):
        if input_.shape != target.shape:
            raise ValueError(f"Expect input and target of same shape, got: {input_.shape}, {target.shape}.")
        if self.exclude_background:
            input_ = input_[:, 1:]
            target = target[:, 1:]
        return cldice_score(input_, target, num_iter=self.num_iter, invert=True, eps=self.eps)


class CombinedclDiceLoss(SoftclDiceLoss):
    """alpha-weighted soft Dice + (1 - alpha) clDice (reference cldice.py:166)."""

    def __init__(self, num_iter: int = 5, alpha: float = 0.5, eps: float = 1e-7,
                 exclude_background: bool = False):
        super().__init__(num_iter=num_iter, eps=eps, exclude_background=exclude_background)
        self.alpha = alpha
        self.init_kwargs = {"num_iter": num_iter, "alpha": alpha, "eps": eps,
                            "exclude_background": exclude_background}

    def __call__(self, input_, target):
        if input_.shape != target.shape:
            raise ValueError(f"Expect input and target of same shape, got: {input_.shape}, {target.shape}.")
        if self.exclude_background:
            input_ = input_[:, 1:]
            target = target[:, 1:]
        cldice = cldice_score(input_, target, num_iter=self.num_iter, invert=True, eps=self.eps)
        dice = dice_score(input_, target, invert=True, channelwise=True, eps=self.eps)
        return self.alpha * dice + (1.0 - self.alpha) * cldice
