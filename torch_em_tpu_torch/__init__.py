"""PyTorch/CUDA port of torch_em_tpu for NVIDIA Hopper.

The same U-Net family, training loop, losses, data path (datasets, the
dataset and loader factories, augmentations on the host and on the card),
tiled prediction, command line interface and parameter-free instance norm as
the JAX package, with channel-first (N, C, *spatial) tensors. The instance
norm runs as hand-written CUDA kernels (forward and backward) on the card and
as their plain PyTorch versions on the CPU. Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

from . import data, loss, models, trainer, transforms, utils
from .data import DataLoader, SegmentationDataset
from .loss import DiceLoss
from .models import AnisotropicUNet, UNet2d, UNet3d
from .ops.instance_norm import instance_norm, instance_norm_reference
from .segmentation import (
    default_segmentation_dataset, default_segmentation_loader, default_segmentation_trainer, get_data_loader,
)
from .trainer import DefaultTrainer, OptimizerSpec, ReduceLROnPlateau
from .transforms import standardize
from .utils import Blocking, predict_with_halo, predict_with_padding, state_dict_from_jax_params

__all__ = [
    "data", "loss", "models", "trainer", "transforms", "utils",
    "AnisotropicUNet", "UNet2d", "UNet3d", "instance_norm", "instance_norm_reference",
    "standardize", "Blocking", "predict_with_halo", "predict_with_padding",
    "state_dict_from_jax_params", "DataLoader", "SegmentationDataset", "DiceLoss",
    "default_segmentation_dataset", "default_segmentation_loader", "default_segmentation_trainer",
    "get_data_loader", "DefaultTrainer", "OptimizerSpec", "ReduceLROnPlateau",
]
