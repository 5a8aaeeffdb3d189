"""Probabilistic U-Net (Kohl et al., arXiv:1806.05034).

Counterpart of ``torch_em_tpu/models/probabilistic_unet.py`` (torch-em's
``model/probabilistic_unet.py``):

- a U-Net (the port's ``UNetModule`` with ``features_encoder=num_filters``,
  2x pooling at every level, ``InstanceNorm``, no output conv) gives
  ``num_filters[0]`` feature maps;
- the prior (on x) and the posterior (on x and y) are axis-aligned Gaussian
  encoders: per level, a 2x2 average pool (past the first level) and
  ``no_convs_per_block`` 3x3 convs with ReLU, then a global spatial mean and
  a 1x1 conv to ``2 * latent_dim`` (mu, log sigma);
- ``fcomb`` tiles a latent sample over space, concatenates it after the
  features and runs ``no_convs_fcomb - 1`` 1x1 convs with ReLU and a last
  1x1 conv to the logits;
- ``sample`` reconstructs from one prior sample; ``elbo`` is ``-(recon +
  beta * KL)``, where the reconstruction loss is the **sum** of the binary
  cross entropy with logits (``rl_swap``: ``DiceLossWithLogits``; with
  ``consensus_masking`` both logits and y are multiplied by ``consm``) and
  the KL is the batch **mean** of the per-sample sums of the analytic KL of
  the diagonal Gaussians.

The model holds no latent state between calls: ``encode`` returns the
distributions' parameters and the features, and ``sample`` and ``elbo`` take
them (``encoded``) or encode themselves. The noise comes from ``noise`` (the
standard-normal draw itself, as a test feeds JAX's) or from ``generator``.
Parameter names follow torch-em's layout (``prior.encoder.layers.<i>``,
``prior.conv_layer``, ``fcomb.layers.<i>``, ``fcomb.last_layer``,
``unet.*``); ``utils.convert`` carries the JAX package's weights over.
"""

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from ..loss.dice import DiceLossWithLogits
from .base import resolve_device
from .unet import UNetModule, _Conv

__all__ = ["ProbabilisticUNet", "ProbabilisticUNetModule"]


class _GaussianEncoder(nn.Module):
    """Convs per level (average pools between levels), a global mean, then (mu, log sigma)."""

    def __init__(self, in_channels: int, num_filters: Sequence[int], no_convs_per_block: int, latent_dim: int):
        super().__init__()
        layers, cin = [], in_channels
        for level, f in enumerate(num_filters):
            if level > 0:
                layers.append(nn.AvgPool2d(2, 2))
            for _ in range(no_convs_per_block):
                layers += [_Conv(2, cin, f, 3, 1), nn.ReLU()]
                cin = f
        # torch-em's Encoder holds its layers as ``encoder.layers``
        self.encoder = nn.Module()
        self.encoder.layers = nn.Sequential(*layers)
        self.conv_layer = _Conv(2, num_filters[-1], 2 * latent_dim, 1, 0)
        self.latent_dim = latent_dim

    def forward(self, x):
        h = self.encoder.layers(x).mean(dim=(2, 3), keepdim=True)
        mu_log_sigma = self.conv_layer(h)[:, :, 0, 0].float()
        return mu_log_sigma[:, :self.latent_dim], mu_log_sigma[:, self.latent_dim:]


class _Fcomb(nn.Module):
    """Features and a latent sample tiled over space, through 1x1 convs to the logits."""

    def __init__(self, num_filters0: int, latent_dim: int, num_classes: int, no_convs_fcomb: int):
        super().__init__()
        layers, cin = [], num_filters0 + latent_dim
        for _ in range(no_convs_fcomb - 1):
            layers += [_Conv(2, cin, num_filters0, 1, 0), nn.ReLU()]
            cin = num_filters0
        self.layers = nn.Sequential(*layers)
        self.last_layer = _Conv(2, num_filters0, num_classes, 1, 0)

    def forward(self, features, z):
        z = z[:, :, None, None].to(features.dtype).expand(-1, -1, *features.shape[2:])
        return self.last_layer(self.layers(torch.cat([features, z], dim=1))).float()


def _kl_diag_gaussians(mu_q, log_sigma_q, mu_p, log_sigma_p):
    """Analytic KL(q || p) of diagonal Gaussians, summed over the latent axis."""
    var_q, var_p = torch.exp(2 * log_sigma_q), torch.exp(2 * log_sigma_p)
    kl = log_sigma_p - log_sigma_q + (var_q + (mu_q - mu_p) ** 2) / (2 * var_p) - 0.5
    return kl.sum(dim=-1)


def _bce_with_logits_sum(logits, target):
    return (logits.clamp_min(0) - logits * target + torch.log1p(torch.exp(-logits.abs()))).sum()


class ProbabilisticUNetModule(nn.Module):
    """The Probabilistic U-Net's computation on channel-first tensors."""

    def __init__(self, input_channels: int, num_classes: int = 1, num_filters: Sequence[int] = (32, 64, 128, 192),
                 latent_dim: int = 6, no_convs_fcomb: int = 4, no_convs_per_block: int = 3, beta: float = 10.0,
                 rl_swap: bool = False, consensus_masking: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        num_filters = list(num_filters)
        self.num_classes = num_classes
        self.beta = beta
        self.rl_swap = rl_swap
        self.consensus_masking = consensus_masking
        self.unet = UNetModule(2, num_filters, [2] * len(num_filters), input_channels, None,
                               norm="InstanceNorm", check_shape=True, dtype=dtype)
        self.prior = _GaussianEncoder(input_channels, num_filters, no_convs_per_block, latent_dim)
        self.posterior = _GaussianEncoder(input_channels + num_classes, num_filters, no_convs_per_block, latent_dim)
        self.fcomb = _Fcomb(num_filters[0], latent_dim, num_classes, no_convs_fcomb)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype of every part (parameters stay float32); the outputs are float32."""
        return self.unet.dtype

    @dtype.setter
    def dtype(self, value: torch.dtype):
        self.unet.dtype = value

    def encode(self, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> Dict[str, object]:
        """The U-Net's features and the prior's (mu, log sigma); given y, the posterior's too."""
        out = {"features": self.unet(x), "prior": self.prior(x.to(self.dtype))}
        if y is not None:
            out["posterior"] = self.posterior(torch.cat([x, y.to(x.dtype)], dim=1).to(self.dtype))
        return out

    def reconstruct(self, features: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Logits of the features combined with the latent sample z."""
        return self.fcomb(features.to(self.dtype), z)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The prior mean's reconstruction (deterministic)."""
        enc = self.encode(x)
        return self.reconstruct(enc["features"], enc["prior"][0])

    @staticmethod
    def draw_noise(mu: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A standard-normal draw of mu's shape, on its device."""
        return torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)

    def sample(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, encoded: Optional[dict] = None) -> torch.Tensor:
        """Logits of one prior sample: mu + sigma * noise."""
        enc = self.encode(x) if encoded is None else encoded
        mu, log_sigma = enc["prior"]
        noise = self.draw_noise(mu, generator) if noise is None else noise
        return self.reconstruct(enc["features"], mu + torch.exp(log_sigma) * noise)

    def elbo(self, x: torch.Tensor, y: torch.Tensor, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None, consm: Optional[torch.Tensor] = None,
             encoded: Optional[dict] = None) -> torch.Tensor:
        """-(reconstruction loss of a posterior sample + beta * KL(posterior || prior))."""
        enc = self.encode(x, y) if encoded is None else encoded
        (mu_q, log_sigma_q), (mu_p, log_sigma_p) = enc["posterior"], enc["prior"]
        noise = self.draw_noise(mu_q, generator) if noise is None else noise
        kl = _kl_diag_gaussians(mu_q, log_sigma_q, mu_p, log_sigma_p).mean()
        logits = self.reconstruct(enc["features"], mu_q + torch.exp(log_sigma_q) * noise)
        if self.consensus_masking and consm is not None:
            logits, y = logits * consm, y * consm
        recon_loss = DiceLossWithLogits()(logits, y) if self.rl_swap else _bce_with_logits_sum(logits, y)
        return -(recon_loss + self.beta * kl)


def ProbabilisticUNet(
    input_channels: int = 1,
    num_classes: int = 1,
    num_filters: Sequence[int] = (32, 64, 128, 192),
    latent_dim: int = 6,
    no_convs_fcomb: int = 4,
    beta: float = 10.0,
    rl_swap: bool = False,
    consensus_masking: bool = False,
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
) -> ProbabilisticUNetModule:
    """Build, initialise (torch's default conv init from ``seed``) and place a Probabilistic U-Net."""
    model = ProbabilisticUNetModule(input_channels, num_classes, num_filters, latent_dim, no_convs_fcomb,
                                    beta=beta, rl_swap=rl_swap, consensus_masking=consensus_masking, dtype=dtype)
    generator = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, _Conv):
            m.reset_parameters(generator)
    model.factory = f"{ProbabilisticUNet.__module__}.{ProbabilisticUNet.__qualname__}"
    model.init_kwargs = {
        "input_channels": input_channels, "num_classes": num_classes, "num_filters": list(num_filters),
        "latent_dim": latent_dim, "no_convs_fcomb": no_convs_fcomb, "beta": beta, "rl_swap": rl_swap,
        "consensus_masking": consensus_masking, "device": str(device), "dtype": dtype, "seed": seed,
    }
    return model.to(resolve_device(device)).eval()
