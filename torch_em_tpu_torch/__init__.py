"""PyTorch/CUDA port of torch_em_tpu for NVIDIA Hopper.

The same U-Net family, UNETR (2D and 3D, with the SAM, CellposeSAM, SAM2
Hiera, SAM3, MAE, ScaleMAE, DINOv2 and DINOv3 encoders) and ViM-UNet (a
Vision Mamba encoder), the Probabilistic U-Net, the 3-D ResNets with the
classification trainer, training loop (with its profiling), the
self-training trainers (MeanTeacher, FixMatch, UniMatch v2), Shallow2Deep
(random forests evaluated in numpy, the enhancer), bioimage.io export and
import, losses, data path (datasets, the
dataset and loader factories, augmentations on the host and on the card),
tiled prediction, multi-device training and inference (``parallel``: one
process per device), instance decodings (watersheds, mutex watershed,
multicut) and their metrics, checkpoint validation, command line interface
and parameter-free instance norm as the JAX package, with channel-first
(N, C, *spatial) tensors. The instance norm runs as hand-written CUDA
kernels (forward and backward) on the card and as their plain PyTorch
versions on the CPU. Entry points run on ``device="cuda"`` unless the caller
passes ``device="cpu"``.
"""

from . import (
    classification, data, loss, metric, models, parallel, self_training, shallow2deep, trainer, transforms, utils,
)
from .data import DataLoader, SegmentationDataset
from .loss import DiceLoss
from .models import (
    UNETR, UNETR2D, UNETR3D, AnisotropicUNet, DinoV2ViT, DinoV3ViT, HieraSam2, MAEViT, Sam3ViT, ScaleMAEViT, UNet2d,
    UNet3d, get_vimunet_model, resnet3d_18, resnet3d_34, resnet3d_50, resnet3d_101, resnet3d_152, resnext3d_50_32x4d,
    resnext3d_101_32x8d, resnext3d_101_64x4d, wide_resnet3d_50_2, wide_resnet3d_101_2,
)
from .ops.instance_norm import instance_norm, instance_norm_reference
from .segmentation import (
    default_segmentation_dataset, default_segmentation_loader, default_segmentation_trainer, get_data_loader,
)
from .trainer import DefaultTrainer, OptimizerSpec, ReduceLROnPlateau
from .transforms import standardize
from .utils import Blocking, predict_with_halo, predict_with_padding, state_dict_from_jax_params

__all__ = [
    "classification", "data", "loss", "metric", "models", "parallel", "self_training", "shallow2deep", "trainer",
    "transforms", "utils",
    "DinoV2ViT", "DinoV3ViT", "HieraSam2", "MAEViT", "Sam3ViT", "ScaleMAEViT", "resnet3d_18", "resnet3d_34",
    "resnet3d_50", "resnet3d_101", "resnet3d_152", "resnext3d_50_32x4d", "resnext3d_101_32x8d",
    "resnext3d_101_64x4d", "wide_resnet3d_50_2", "wide_resnet3d_101_2",
    "AnisotropicUNet", "UNet2d", "UNet3d", "UNETR", "UNETR2D", "UNETR3D", "get_vimunet_model", "instance_norm", "instance_norm_reference",
    "standardize", "Blocking", "predict_with_halo", "predict_with_padding",
    "state_dict_from_jax_params", "DataLoader", "SegmentationDataset", "DiceLoss",
    "default_segmentation_dataset", "default_segmentation_loader", "default_segmentation_trainer",
    "get_data_loader", "DefaultTrainer", "OptimizerSpec", "ReduceLROnPlateau",
]
