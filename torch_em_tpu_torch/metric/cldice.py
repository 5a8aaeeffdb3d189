"""clDice metric (reference torch_em/metric/cldice.py).

The port's copy of the JAX package's ``metric/cldice.py``.
skimage.morphology.skeletonize is not available; the 'skimage' method uses
an iterative morphological thinning in numpy with the same functional role,
and 'soft' uses the differentiable ``SoftSkeletonize`` on CPU tensors.
"""

import numpy as np
import torch
from scipy import ndimage

from ..loss.cldice import SoftSkeletonize

__all__ = ["cl_score", "clDice", "skeletonize"]


def skeletonize(mask: np.ndarray, max_iter: int = 100) -> np.ndarray:
    """Morphological skeleton via iterative erosion + opening residue
    (functional spec: skimage.morphology.skeletonize)."""
    img = np.asarray(mask).astype(bool)
    skel = np.zeros_like(img)
    structure = ndimage.generate_binary_structure(img.ndim, 2)
    for _ in range(max_iter):
        if not img.any():
            break
        eroded = ndimage.binary_erosion(img, structure=structure)
        opened = ndimage.binary_dilation(eroded, structure=structure)
        skel |= img & ~opened
        img = eroded
    return skel


def cl_score(img, skel):
    """Skeleton volume intersection (reference metric/cldice.py)."""
    return np.sum(img * skel) / max(np.sum(skel), 1e-7)


def clDice(input_, target, skeletonize_method: str = "skimage", num_iter: int = 5):
    """clDice score between binary input and target (reference metric/cldice.py)."""
    if input_.shape != target.shape:
        raise ValueError(f"Expect input and target of same shape, got: {input_.shape}, {target.shape}.")

    if skeletonize_method == "skimage":
        skel_input = skeletonize(input_).astype(input_.dtype)
        skel_target = skeletonize(target).astype(target.dtype)
    elif skeletonize_method == "soft":
        soft = SoftSkeletonize(num_iter=num_iter)
        with torch.no_grad():
            skel_input = soft(torch.as_tensor(input_, dtype=torch.float32)[None, None]).numpy().squeeze()
            skel_target = soft(torch.as_tensor(target, dtype=torch.float32)[None, None]).numpy().squeeze()
    else:
        raise ValueError("Unknown option for `skeletonize_method`. Valid options are `skimage` and `soft`.")

    t_prec = cl_score(target, skel_input)
    t_sens = cl_score(input_, skel_target)
    return 2.0 * (t_prec * t_sens) / max(t_prec + t_sens, 1e-7)
