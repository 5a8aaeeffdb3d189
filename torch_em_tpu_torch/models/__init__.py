from .base import get_activation, resolve_device
from .probabilistic_unet import ProbabilisticUNet, ProbabilisticUNetModule
from .unet import AnisotropicUNet, UNet2d, UNet3d, UNetModule
from .unetr import UNETR, UNETR2D, UNETR3D, DepthStripPooling
from .vim import ViM, get_vim_encoder, get_vimunet_model, load_vim_weights
from .vit import ViT, get_vision_transformer, load_sam_weights

__all__ = [
    "AnisotropicUNet", "ProbabilisticUNet", "ProbabilisticUNetModule", "UNet2d", "UNet3d", "UNetModule", "get_activation", "resolve_device",
    "UNETR", "UNETR2D", "UNETR3D", "DepthStripPooling", "ViM", "get_vim_encoder", "get_vimunet_model",
    "load_vim_weights", "ViT", "get_vision_transformer", "load_sam_weights",
]
