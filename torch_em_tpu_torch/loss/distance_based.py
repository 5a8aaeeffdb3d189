"""Distance-based instance segmentation losses (reference torch_em/loss/distance_based.py);
the port's counterpart of the JAX package's ``loss/distance_based.py``."""

import torch

from .dice import DiceLoss

__all__ = ["DistanceLoss", "DiceBasedDistanceLoss", "mse_loss"]


def mse_loss(pred, target):
    return torch.mean((pred - target) ** 2)


class DistanceLoss:
    """Loss on (foreground, center-distance, boundary-distance) channels
    (reference distance_based.py:7). Per-channel slicing is preserved so the
    Dice loss treats each channel independently (see the note at :37-46)."""

    def __init__(self, mask_distances_in_bg: bool = True, foreground_loss=None, distance_loss=None):
        self.foreground_loss = DiceLoss() if foreground_loss is None else foreground_loss
        self.distance_loss = mse_loss if distance_loss is None else distance_loss
        self.mask_distances_in_bg = mask_distances_in_bg
        self.init_kwargs = {"mask_distances_in_bg": mask_distances_in_bg}

    def __call__(self, input_, target):
        assert input_.shape == target.shape, input_.shape
        assert input_.shape[1] == 3, input_.shape

        fg_input, fg_target = input_[:, 0:1], target[:, 0:1]
        fg_loss = self.foreground_loss(fg_input, fg_target)

        cdist_input, cdist_target = input_[:, 1:2], target[:, 1:2]
        bdist_input, bdist_target = input_[:, 2:3], target[:, 2:3]
        if self.mask_distances_in_bg:
            mask = fg_target
            cdist_loss = self.distance_loss(cdist_input * mask, cdist_target * mask)
            bdist_loss = self.distance_loss(bdist_input * mask, bdist_target * mask)
        else:
            cdist_loss = self.distance_loss(cdist_input, cdist_target)
            bdist_loss = self.distance_loss(bdist_input, bdist_target)

        return fg_loss + cdist_loss + bdist_loss


class DiceBasedDistanceLoss(DistanceLoss):
    """DistanceLoss with dice for all channels (reference distance_based.py:62)."""

    def __init__(self, mask_distances_in_bg: bool):
        super().__init__(mask_distances_in_bg, foreground_loss=DiceLoss(), distance_loss=DiceLoss())
        self.init_kwargs = {"mask_distances_in_bg": mask_distances_in_bg}
