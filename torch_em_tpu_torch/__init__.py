"""PyTorch/CUDA port of torch_em_tpu for NVIDIA Hopper.

The same U-Net family, UNETR (2D and 3D, with a SAM-geometry ViT encoder)
and ViM-UNet (a Vision Mamba encoder), the Probabilistic U-Net, training loop (with its profiling), the
self-training trainers (MeanTeacher, FixMatch, UniMatch v2), losses, data path (datasets, the
dataset and loader factories, augmentations on the host and on the card),
tiled prediction, instance decodings (watersheds, mutex watershed,
multicut) and their metrics, checkpoint validation, command line interface
and parameter-free instance norm as the JAX package, with channel-first
(N, C, *spatial) tensors. The instance norm runs as hand-written CUDA
kernels (forward and backward) on the card and as their plain PyTorch
versions on the CPU. Entry points run on ``device="cuda"`` unless the caller
passes ``device="cpu"``.
"""

from . import data, loss, metric, models, self_training, trainer, transforms, utils
from .data import DataLoader, SegmentationDataset
from .loss import DiceLoss
from .models import UNETR, UNETR2D, UNETR3D, AnisotropicUNet, UNet2d, UNet3d, get_vimunet_model
from .ops.instance_norm import instance_norm, instance_norm_reference
from .segmentation import (
    default_segmentation_dataset, default_segmentation_loader, default_segmentation_trainer, get_data_loader,
)
from .trainer import DefaultTrainer, OptimizerSpec, ReduceLROnPlateau
from .transforms import standardize
from .utils import Blocking, predict_with_halo, predict_with_padding, state_dict_from_jax_params

__all__ = [
    "data", "loss", "metric", "models", "self_training", "trainer", "transforms", "utils",
    "AnisotropicUNet", "UNet2d", "UNet3d", "UNETR", "UNETR2D", "UNETR3D", "get_vimunet_model", "instance_norm", "instance_norm_reference",
    "standardize", "Blocking", "predict_with_halo", "predict_with_padding",
    "state_dict_from_jax_params", "DataLoader", "SegmentationDataset", "DiceLoss",
    "default_segmentation_dataset", "default_segmentation_loader", "default_segmentation_trainer",
    "get_data_loader", "DefaultTrainer", "OptimizerSpec", "ReduceLROnPlateau",
]
