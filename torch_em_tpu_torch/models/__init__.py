from .base import get_activation, resolve_device
from .unet import AnisotropicUNet, UNet2d, UNet3d, UNetModule

__all__ = ["AnisotropicUNet", "UNet2d", "UNet3d", "UNetModule", "get_activation", "resolve_device"]
