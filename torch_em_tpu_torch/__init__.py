"""PyTorch/CUDA port of torch_em_tpu for NVIDIA Hopper.

The same U-Net family, tiled prediction and parameter-free instance norm as
the JAX package, with channel-first (N, C, *spatial) tensors. The instance
norm runs as a hand-written CUDA kernel on the card and as its plain PyTorch
version on the CPU. Entry points run on ``device="cuda"`` unless the caller
passes ``device="cpu"``.
"""

from .models import AnisotropicUNet, UNet2d, UNet3d
from .ops.instance_norm import instance_norm, instance_norm_reference
from .transforms import standardize
from .utils import Blocking, predict_with_halo, predict_with_padding, state_dict_from_jax_params

__all__ = [
    "AnisotropicUNet", "UNet2d", "UNet3d", "instance_norm", "instance_norm_reference",
    "standardize", "Blocking", "predict_with_halo", "predict_with_padding",
    "state_dict_from_jax_params",
]
