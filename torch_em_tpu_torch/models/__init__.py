from .base import get_activation, resolve_device
from .dino import DinoV2ViT, DinoV3ViT
from .hiera import HieraSam2
from .probabilistic_unet import ProbabilisticUNet, ProbabilisticUNetModule
from .resnet3d import (
    ResNet3dModule, resnet3d_18, resnet3d_34, resnet3d_50, resnet3d_101, resnet3d_152, resnext3d_50_32x4d,
    resnext3d_101_32x8d, resnext3d_101_64x4d, wide_resnet3d_50_2, wide_resnet3d_101_2,
)
from .sam3 import Sam3ViT
from .scalemae import MAEViT, ScaleMAEViT
from .unet import AnisotropicUNet, UNet2d, UNet3d, UNetModule
from .unetr import UNETR, UNETR2D, UNETR3D, DepthStripPooling
from .vim import ViM, get_vim_encoder, get_vimunet_model, load_vim_weights
from .vit import ViT, get_vision_transformer, load_sam_weights

__all__ = [
    "AnisotropicUNet", "ProbabilisticUNet", "ProbabilisticUNetModule", "UNet2d", "UNet3d", "UNetModule", "get_activation", "resolve_device",
    "UNETR", "UNETR2D", "UNETR3D", "DepthStripPooling", "ViM", "get_vim_encoder", "get_vimunet_model",
    "load_vim_weights", "ViT", "get_vision_transformer", "load_sam_weights",
    "DinoV2ViT", "DinoV3ViT", "Sam3ViT", "MAEViT", "ScaleMAEViT", "HieraSam2",
    "ResNet3dModule", "resnet3d_18", "resnet3d_34", "resnet3d_50", "resnet3d_101", "resnet3d_152",
    "resnext3d_50_32x4d", "resnext3d_101_32x8d", "resnext3d_101_64x4d", "wide_resnet3d_50_2", "wide_resnet3d_101_2",
]
