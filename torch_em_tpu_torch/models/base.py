"""Activations by name and the device an entry point runs on.

Counterpart of ``torch_em_tpu/models/base.py`` (``ACTIVATIONS``,
``get_activation``). The activations take channel-first tensors.
"""

from typing import Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F

__all__ = ["ACTIVATIONS", "get_activation", "resolve_device"]


ACTIVATIONS: Dict[str, Callable] = {
    "Sigmoid": torch.sigmoid,
    "Softmax": lambda x: torch.softmax(x, dim=1),
    "Tanh": torch.tanh,
    "ReLU": torch.relu,
    "LeakyReLU": F.leaky_relu,
    # jax.nn.gelu, which the JAX package uses, is the tanh approximation
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "Identity": lambda x: x,
    "ELU": F.elu,
}


def get_activation(activation: Optional[Union[str, Callable]]) -> Optional[Callable]:
    """Resolve an activation given by name (torch-style, e.g. 'Sigmoid') or callable."""
    if activation is None:
        return None
    if callable(activation):
        return activation
    if isinstance(activation, str) and activation in ACTIVATIONS:
        return ACTIVATIONS[activation]
    raise ValueError(f"Invalid activation: {activation}")


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on; a CUDA device must be present when one is asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device
