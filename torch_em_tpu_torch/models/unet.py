"""U-Net model family: UNet2d, UNet3d, AnisotropicUNet.

Counterpart of ``torch_em_tpu/models/unet.py``: the same encoder / base /
decoder computation with channel-first (N, C, *spatial) tensors throughout.
``ConvBlock`` is two [norm -> conv (same padding) -> ReLU] stages with the
parameter-free instance norm by default; the encoder max-pools; the decoder
upsamples with a 1x1 conv followed by linear interpolation, concatenates the
skip and runs a ``ConvBlock``. The JAX package's TPU layout work (width
packing, phase convs, the norm fold, the 2.5D mode) computes the same math
and has no counterpart here.

``dtype`` is the compute type, as flax's ``dtype``: parameters stay float32
and are cast to it at each use; the output is float32. A trainer with
``mixed_precision`` sets it to bfloat16 for its steps. The factories record
their arguments in ``model.init_kwargs`` and their import path in
``model.factory``, so a trainer checkpoint can rebuild the model. Parameter names
follow torch-em's state-dict layout (``encoder.blocks.<i>.block.{1,4}``,
``base.block.{1,4}``, ``decoder.samplers.<i>.conv``, ``out_conv``), so
torch-em checkpoints load, and ``utils.convert`` carries JAX weights over.
"""

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.instance_norm import instance_norm
from .base import get_activation, resolve_device

__all__ = [
    "UNet2d", "UNet3d", "AnisotropicUNet", "UNetModule", "POSTPROCESSING",
    "AccumulateChannels", "ConvBlock", "Upsampler", "InstanceNorm",
]


class AccumulateChannels:
    """Accumulate affinity channels into boundaries (channel-first tensors)."""

    def __init__(self, invariant_channels, accumulate_channels, accumulator):
        if accumulator not in ("mean", "min", "max"):
            raise ValueError(f"Invalid accumulator: {accumulator}")
        self.invariant_channels = invariant_channels
        self.accumulate_channels = accumulate_channels
        self.accumulator = {"mean": torch.mean, "min": torch.amin, "max": torch.amax}[accumulator]

    def __call__(self, x):
        c0, c1 = self.accumulate_channels
        acc = self.accumulator(x[:, c0:c1], dim=1, keepdim=True)
        if self.invariant_channels is None:
            return acc
        i0, i1 = self.invariant_channels
        return torch.cat([x[:, i0:i1], acc], dim=1)


POSTPROCESSING = {
    "affinities_to_boundaries_anisotropic": lambda: AccumulateChannels(None, (1, 3), "max"),
    "affinities_to_boundaries2d": lambda: AccumulateChannels(None, (0, 2), "max"),
    "affinities_with_foreground_to_boundaries2d": lambda: AccumulateChannels((0, 1), (1, 3), "max"),
    "affinities_to_boundaries3d": lambda: AccumulateChannels(None, (0, 3), "max"),
    "affinities_with_foreground_to_boundaries3d": lambda: AccumulateChannels((0, 1), (1, 4), "max"),
}


def _get_postprocessing(postprocessing):
    if postprocessing is None:
        return None
    if callable(postprocessing):
        return postprocessing
    if postprocessing in POSTPROCESSING:
        return POSTPROCESSING[postprocessing]()
    raise ValueError(f"Invalid postprocessing: {postprocessing}")


def _to_tuple(v, dim):
    return (v,) * dim if isinstance(v, int) else tuple(v)


class InstanceNorm(nn.Module):
    """Parameter-free instance norm over the spatial axes (torch InstanceNorm*d default).

    Differentiable through ``InstanceNormFunction``: the hand-written forward
    and backward kernels on the card, their plain versions on the CPU."""

    def forward(self, x):
        return instance_norm(x)


def _NormLayer(norm: str) -> nn.Module:
    if norm == "InstanceNorm":
        return InstanceNorm()
    if norm in ("InstanceNormTrackStats", "GroupNorm", "BatchNorm"):
        raise NotImplementedError(
            f"norm={norm!r} is not ported yet (ROADMAP.md, Queue 1); use 'InstanceNorm' or None"
        )
    raise ValueError(
        f"Invalid norm: expect one of 'InstanceNorm', 'BatchNorm' or 'GroupNorm', got {norm}"
    )


class _Conv(nn.Module):
    """Convolution with float32 parameters, run in the input's dtype.

    ``weight`` is (O, I, *kernel) and ``bias`` (O,), as in ``nn.ConvNd``."""

    def __init__(self, dim, in_channels, out_channels, kernel_size, padding):
        super().__init__()
        self.kernel_size = _to_tuple(kernel_size, dim)
        self.padding = _to_tuple(padding, dim)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self._conv = F.conv3d if dim == 3 else F.conv2d

    def reset_parameters(self, generator: torch.Generator):
        """torch's default conv init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias."""
        bound = (self.weight[0].numel()) ** -0.5
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return self._conv(x, self.weight.to(x.dtype), self.bias.to(x.dtype), padding=self.padding)


class ConvBlock(nn.Module):
    """Two [norm -> conv -> ReLU] stages."""

    def __init__(self, in_channels, out_channels, dim, kernel_size=3, padding=1,
                 norm: Optional[str] = "InstanceNorm"):
        super().__init__()
        layers = []
        for cin in (in_channels, out_channels):
            if norm is not None:
                layers.append(_NormLayer(norm))
            layers += [_Conv(dim, cin, out_channels, kernel_size, padding), nn.ReLU()]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        return self.block(x)


class Upsampler(nn.Module):
    """1x1 conv, then linear interpolation by the per-axis scale factor.

    The conv runs before the interpolation, as in the JAX package: the two
    commute, and the conv then touches fewer voxels."""

    def __init__(self, in_channels, out_channels, scale_factor, dim):
        super().__init__()
        self.scale_factor = _to_tuple(scale_factor, dim)
        self.mode = "trilinear" if dim == 3 else "bilinear"
        self.conv = _Conv(dim, in_channels, out_channels, 1, 0)

    def forward(self, x):
        x = self.conv(x)
        size = [s * f for s, f in zip(x.shape[2:], self.scale_factor)]
        return F.interpolate(x, size=size, mode=self.mode, align_corners=False)


class Encoder(nn.Module):
    def __init__(self, blocks, scale_factors):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.scale_factors = list(scale_factors)

    def forward(self, x):
        skips = []
        for block, sf in zip(self.blocks, self.scale_factors):
            x = block(x)
            skips.append(x)
            pool = F.max_pool3d if len(sf) == 3 else F.max_pool2d
            x = pool(x, kernel_size=sf, stride=sf)
        return x, skips


class Decoder(nn.Module):
    def __init__(self, blocks, samplers):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.samplers = nn.ModuleList(samplers)

    @staticmethod
    def _crop(skip, shape):
        """Center-crop ``skip`` to the spatial ``shape`` (a no-op with same padding)."""
        offsets = [(s - t) // 2 for s, t in zip(skip.shape[2:], shape)]
        crop = tuple(slice(o, o + t) for o, t in zip(offsets, shape))
        return skip[(slice(None), slice(None)) + crop]

    def forward(self, x, skips):
        for block, sampler, skip in zip(self.blocks, self.samplers, skips[::-1]):
            x = sampler(x)
            x = block(torch.cat([x, self._crop(skip, x.shape[2:])], dim=1))
        return x


def _update_conv_kwargs(kernel_size, padding, scale_factor):
    """Anisotropic kernels: 1/0 on axes with scale factor 1."""
    sf = scale_factor if isinstance(scale_factor, (list, tuple)) else [scale_factor]
    if isinstance(scale_factor, int) or list(sf).count(sf[0]) == len(sf):
        return kernel_size, padding
    if not (isinstance(kernel_size, int) and isinstance(padding, int)):
        return kernel_size, padding
    ks = tuple(1 if factor == 1 else kernel_size for factor in sf)
    pd = tuple(0 if factor == 1 else padding for factor in sf)
    return ks, pd


class UNetModule(nn.Module):
    """Encoder, base and decoder of a U-Net on channel-first (N, C, *spatial) tensors."""

    def __init__(
        self,
        dim: int,
        features_encoder: Sequence[int],
        scale_factors: Sequence,
        in_channels: int,
        out_channels: Optional[int],
        final_activation: Optional[Union[str, Callable]] = None,
        postprocessing: Optional[Union[str, Callable]] = None,
        norm: Optional[str] = "InstanceNorm",
        kernel_size=3,
        padding=1,
        anisotropic_kernel: bool = False,
        check_shape: bool = True,
        gain: int = 2,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dim = dim
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.scale_factors = [_to_tuple(sf, dim) for sf in scale_factors]
        self.check_shape = check_shape
        self.dtype = dtype
        self.final_activation = get_activation(final_activation)
        self.postprocessing = _get_postprocessing(postprocessing)
        feats = list(features_encoder)
        if len(feats) != len(self.scale_factors):
            raise ValueError("features_encoder and scale_factors need one entry per level")

        def block(cin, cout, sf):
            ks, pd = kernel_size, padding
            if anisotropic_kernel:
                ks, pd = _update_conv_kwargs(ks, pd, list(sf))
            return ConvBlock(cin, cout, dim, ks, pd, norm=norm)

        self.encoder = Encoder(
            [block(cin, f, sf) for cin, f, sf in
             zip([in_channels] + feats[:-1], feats, self.scale_factors)],
            self.scale_factors,
        )
        base_features = feats[-1] * gain
        self.base = block(feats[-1], base_features, self.scale_factors[-1])
        decoder_feats = feats[::-1]
        decoder_sfs = self.scale_factors[::-1]
        self.decoder = Decoder(
            [block(2 * f, f, sf) for f, sf in zip(decoder_feats, decoder_sfs)],
            [Upsampler(cin, f, sf, dim) for cin, f, sf in
             zip([base_features] + decoder_feats[:-1], decoder_feats, decoder_sfs)],
        )
        self.out_conv = None if out_channels is None else _Conv(dim, feats[0], out_channels, 1, 0)

    def _check_input_shape(self, x):
        spatial_shape = tuple(x.shape)[2:]
        factor = [int(np.prod([sf[i] for sf in self.scale_factors])) for i in range(self.dim)]
        if len(spatial_shape) != len(factor):
            raise ValueError(
                f"Invalid shape for U-Net: dimensions don't agree {len(spatial_shape)} != {len(factor)}"
            )
        if any(sh % fac != 0 for sh, fac in zip(spatial_shape, factor)):
            raise ValueError(f"Invalid shape for U-Net: {spatial_shape} is not divisible by {factor}")

    def forward(self, x):
        if self.check_shape:
            self._check_input_shape(x)
        h, skips = self.encoder(x.to(self.dtype))
        h = self.decoder(self.base(h), skips)
        if self.out_conv is not None:
            h = self.out_conv(h)
        out = h.float()
        if self.final_activation is not None:
            out = self.final_activation(out)
        if self.postprocessing is not None:
            out = self.postprocessing(out)
        return out


def _build_unet(factory, init_kwargs, dim, in_channels, out_channels, scale_factors,
                initial_features, gain, device, seed, **kwargs) -> UNetModule:
    """Build, initialise and place a U-Net; ``factory`` and ``init_kwargs`` (the
    factory's own arguments) let a trainer checkpoint rebuild it."""
    feats = [initial_features * gain ** i for i in range(len(scale_factors))]
    model = UNetModule(dim, feats, scale_factors, in_channels, out_channels, gain=gain, **kwargs)
    generator = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, _Conv):
            m.reset_parameters(generator)
    model.factory = f"{factory.__module__}.{factory.__qualname__}"
    model.init_kwargs = {**init_kwargs, "device": str(device), "seed": seed}
    return model.to(resolve_device(device)).eval()


def UNet2d(
    in_channels: int,
    out_channels: Optional[int],
    depth: int = 4,
    initial_features: int = 32,
    gain: int = 2,
    final_activation: Optional[Union[str, Callable]] = None,
    postprocessing: Optional[Union[str, Callable]] = None,
    check_shape: bool = True,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    **conv_block_kwargs,
) -> UNetModule:
    """2D U-Net with 2x pooling at every level."""
    init_kwargs = dict(
        in_channels=in_channels, out_channels=out_channels, depth=depth,
        initial_features=initial_features, gain=gain, final_activation=final_activation,
        postprocessing=postprocessing, check_shape=check_shape, dtype=dtype, **conv_block_kwargs,
    )
    return _build_unet(
        UNet2d, init_kwargs, 2, in_channels, out_channels, [2] * depth, initial_features, gain,
        device, seed, final_activation=final_activation, postprocessing=postprocessing,
        check_shape=check_shape, dtype=dtype, **conv_block_kwargs,
    )


def AnisotropicUNet(
    in_channels: int,
    out_channels: Optional[int],
    scale_factors: List[List[int]],
    initial_features: int = 32,
    gain: int = 2,
    final_activation: Optional[Union[str, Callable]] = None,
    anisotropic_kernel: bool = False,
    postprocessing: Optional[Union[str, Callable]] = None,
    check_shape: bool = True,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    **conv_block_kwargs,
) -> UNetModule:
    """3D U-Net with per-level (possibly anisotropic) scale factors."""
    init_kwargs = dict(
        in_channels=in_channels, out_channels=out_channels, scale_factors=scale_factors,
        initial_features=initial_features, gain=gain, final_activation=final_activation,
        anisotropic_kernel=anisotropic_kernel, postprocessing=postprocessing,
        check_shape=check_shape, dtype=dtype, **conv_block_kwargs,
    )
    return _build_unet(
        AnisotropicUNet, init_kwargs, 3, in_channels, out_channels, scale_factors,
        initial_features, gain, device, seed, final_activation=final_activation,
        anisotropic_kernel=anisotropic_kernel, postprocessing=postprocessing,
        check_shape=check_shape, dtype=dtype, **conv_block_kwargs,
    )


def UNet3d(
    in_channels: int,
    out_channels: Optional[int],
    depth: int = 4,
    initial_features: int = 32,
    gain: int = 2,
    final_activation: Optional[Union[str, Callable]] = None,
    postprocessing: Optional[Union[str, Callable]] = None,
    check_shape: bool = True,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    **conv_block_kwargs,
) -> UNetModule:
    """3D U-Net with isotropic 2x pooling at every level."""
    init_kwargs = dict(
        in_channels=in_channels, out_channels=out_channels, depth=depth,
        initial_features=initial_features, gain=gain, final_activation=final_activation,
        postprocessing=postprocessing, check_shape=check_shape, dtype=dtype, **conv_block_kwargs,
    )
    return _build_unet(
        UNet3d, init_kwargs, 3, in_channels, out_channels, [2] * depth, initial_features, gain,
        device, seed, final_activation=final_activation, postprocessing=postprocessing,
        check_shape=check_shape, dtype=dtype, **conv_block_kwargs,
    )
