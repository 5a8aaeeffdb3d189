"""U-Net model family: UNet2d, UNet3d, AnisotropicUNet.

Counterpart of ``torch_em_tpu/models/unet.py``: the same encoder / base /
decoder computation with channel-first (N, C, *spatial) tensors throughout.
``ConvBlock`` is two [norm -> conv (same padding) -> ReLU] stages with the
parameter-free instance norm by default (``norm`` may also be
``"InstanceNormTrackStats"``, ``"GroupNorm"``, ``"BatchNorm"`` or None); the
encoder max-pools; the decoder upsamples with a 1x1 conv followed by linear
interpolation, concatenates the skip and runs a ``ConvBlock``. With
``return_side_outputs`` every decoder level has its own output conv
(``out_conv.<i>``, the deepest first) and the model returns a list of
outputs, the full-resolution one first. The JAX package's TPU layout work (width
packing, phase convs, the norm fold, the 2.5D mode) computes the same math
and has no counterpart here.

Under ``torch.use_deterministic_algorithms(True)`` the 3-D encoders pool
through ``window_max_pool``: the same values, with a backward that adds
nothing with atomics (PyTorch refuses the backward of ``F.max_pool3d`` on
the card in that mode; ``F.max_pool2d``'s and ``F.interpolate``'s run).

``dtype`` is the compute type, as flax's ``dtype``: parameters stay float32
and are cast to it at each use; the output is float32. A trainer with
``mixed_precision`` sets it to bfloat16 for its steps. The factories record
their arguments in ``model.init_kwargs`` and their import path in
``model.factory``, so a trainer checkpoint can rebuild the model. Parameter names
follow torch-em's state-dict layout (``encoder.blocks.<i>.block.{1,4}``,
``base.block.{1,4}``, norms at ``block.{0,3}``, ``decoder.samplers.<i>.conv``,
``out_conv``), so
torch-em checkpoints load, and ``utils.convert`` carries JAX weights over.
"""

from functools import partial
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.instance_norm import instance_norm
from ..ops.resize import resize
from .base import get_activation, resolve_device

__all__ = [
    "UNet2d", "UNet3d", "AnisotropicUNet", "UNetModule", "POSTPROCESSING",
    "AccumulateChannels", "ConvBlock", "ConvBlock2d", "ConvBlock3d", "Upsampler", "Upsampler2d", "Upsampler3d",
    "InstanceNorm", "InstanceNormTrackStats", "GroupNorm", "BatchNorm", "window_max_pool",
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


def _norm_dtype(x):
    """The dtype a norm computes in: float32, or float64 for a float64 input."""
    return torch.promote_types(x.dtype, torch.float32)


class _AffineNorm(nn.Module):
    """Per-channel ``weight`` (ones) and ``bias`` (zeros) in float32; with ``running``, also
    ``running_mean`` (zeros), ``running_var`` (ones) and torch's ``num_batches_tracked``.
    The norm computes in float32 (float64 for a float64 input) and returns the input's
    dtype, as the JAX package's.

    ``process_group``, which the data-parallel trainer sets, makes the statistics over the
    batch those of the whole batch that the group's processes hold between them (each
    holding as many samples), as the JAX package's norms compute them over a batch that
    its mesh shards."""

    process_group = None

    def __init__(self, channels: int, running: bool, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        if running:
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))
            self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def _channel(self, v, ndim):
        return v.reshape((1, -1) + (1,) * (ndim - 2))

    def _affine(self, xhat, dtype):
        return (self._channel(self.weight, xhat.ndim) * xhat + self._channel(self.bias, xhat.ndim)).to(dtype)

    def _running(self, xf):
        return (xf - self._channel(self.running_mean, xf.ndim)) * torch.rsqrt(
            self._channel(self.running_var, xf.ndim) + self.eps)

    def _batch_mean(self, t, axes, differentiable=True):
        """Mean of ``t`` over ``axes`` of the batch, and over the batches of ``process_group``'s
        processes when it is set: there through ``all_reduce``, whose backward sends each
        process its share of the gradient."""
        if self.process_group is None:
            return t.mean(dim=axes)
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce

        total = t.sum(dim=axes)
        if differentiable:
            total = all_reduce(total, group=self.process_group)
        else:
            dist.all_reduce(total, group=self.process_group)
        count = t.numel() // total.numel() * dist.get_world_size(self.process_group)
        return total / count

    @torch.no_grad()
    def _track(self, mean, var, momentum):
        """running <- (1 - momentum) * running + momentum * observed."""
        self.running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
        self.running_var.mul_(1 - momentum).add_(var, alpha=momentum)
        self.num_batches_tracked += 1


class InstanceNormTrackStats(_AffineNorm):
    """Affine instance norm with running statistics, torch's ``InstanceNorm*d(affine=True,
    track_running_stats=True)``: in training each sample is normalized by its own statistics
    and the running mean and unbiased variance move by ``momentum`` 0.1 towards the batch's
    averages; in eval the running statistics normalize."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(channels, running=True, eps=eps)
        self.momentum = momentum

    def forward(self, x):
        xf = x.to(_norm_dtype(x))
        if not self.training:
            return self._affine(self._running(xf), x.dtype)
        axes = tuple(range(2, x.ndim))
        mean = xf.mean(dim=axes, keepdim=True)
        var = torch.square(xf - mean).mean(dim=axes, keepdim=True)
        n = float(np.prod(x.shape[2:]))
        self._track(self._batch_mean(mean.detach(), (0,), differentiable=False).reshape(-1),
                    self._batch_mean(var.detach(), (0,), differentiable=False).reshape(-1) * (n / max(n - 1.0, 1.0)),
                    self.momentum)
        return self._affine((xf - mean) * torch.rsqrt(var + self.eps), x.dtype)


class BatchNorm(_AffineNorm):
    """Batch norm as flax's ``nn.BatchNorm(momentum=0.9)``, which the JAX package uses: in
    training the batch's mean and biased variance normalize, and the running statistics move
    by ``momentum`` 0.1 towards them; in eval the running statistics normalize. (torch's
    ``BatchNorm*d`` keeps the unbiased variance in its running statistics.)"""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(channels, running=True, eps=eps)
        self.momentum = momentum

    def forward(self, x):
        xf = x.to(_norm_dtype(x))
        if not self.training:
            return self._affine(self._running(xf), x.dtype)
        axes = (0,) + tuple(range(2, x.ndim))
        mean = self._channel(self._batch_mean(xf, axes), x.ndim)
        var = self._channel(self._batch_mean(torch.square(xf - mean), axes), x.ndim)
        self._track(mean.reshape(-1), var.reshape(-1), self.momentum)
        return self._affine((xf - mean) * torch.rsqrt(var + self.eps), x.dtype)


class GroupNorm(_AffineNorm):
    """Affine group norm with ``min(32, channels)`` groups, as the JAX package's flax ``GroupNorm``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, running=False, eps=eps)
        self.num_groups = min(32, channels)

    def forward(self, x):
        dtype = _norm_dtype(x)
        return F.group_norm(x.to(dtype), self.num_groups, self.weight.to(dtype), self.bias.to(dtype),
                            self.eps).to(x.dtype)


def _NormLayer(norm: str, channels: int) -> nn.Module:
    if norm == "InstanceNorm":
        return InstanceNorm()
    if norm == "InstanceNormTrackStats":
        return InstanceNormTrackStats(channels)
    if norm == "GroupNorm":
        return GroupNorm(channels)
    if norm == "BatchNorm":
        return BatchNorm(channels)
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
                layers.append(_NormLayer(norm, cin))
            layers += [_Conv(dim, cin, out_channels, kernel_size, padding), nn.ReLU()]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        return self.block(x)


ConvBlock2d = partial(ConvBlock, dim=2)
ConvBlock3d = partial(ConvBlock, dim=3)

# jax.image.resize's method names: linear and its aliases, nearest, cubic and its aliases, Lanczos
_LINEAR, _NEAREST = ("linear", "bilinear", "trilinear", "triangle"), ("nearest",)
_CUBIC, _LANCZOS = ("cubic", "bicubic", "tricubic"), ("lanczos3", "lanczos5")


class Upsampler(nn.Module):
    """1x1 conv, then interpolation by the per-axis scale factor.

    ``mode`` is the JAX package's (a ``jax.image.resize`` method): ``"linear"``
    (the default) interpolates linearly, ``"nearest"`` takes the nearest input
    pixel; both with half-pixel centres (``align_corners=False``,
    ``"nearest-exact"``). ``"cubic"`` (Keys, a = -0.5; also ``"bicubic"`` and
    ``"tricubic"``), ``"lanczos3"`` and ``"lanczos5"`` multiply each resized axis
    with ``jax.image.resize``'s weight matrix (``ops/resize.py``), so autograd gives
    the backward. The conv runs before the interpolation, as in the JAX package:
    the two commute (every method's weights sum to one), and the conv then touches
    fewer voxels."""

    def __init__(self, in_channels, out_channels, scale_factor, dim, mode: str = "linear"):
        super().__init__()
        if mode not in _LINEAR + _NEAREST + _CUBIC + _LANCZOS:
            raise ValueError(f"Invalid upsampling mode: {mode!r}")
        self.scale_factor = _to_tuple(scale_factor, dim)
        self.mode = mode
        linear = mode in _LINEAR
        self._method = "cubic" if mode in _CUBIC else mode if mode in _LANCZOS else None
        self._interpolation = ("trilinear" if dim == 3 else "bilinear") if linear else "nearest-exact"
        self._align_corners = False if linear else None
        self.conv = _Conv(dim, in_channels, out_channels, 1, 0)

    def forward(self, x):
        x = self.conv(x)
        size = [s * f for s, f in zip(x.shape[2:], self.scale_factor)]
        if self._method is not None:
            return resize(x, list(x.shape[:2]) + size, self._method)
        return F.interpolate(x, size=size, mode=self._interpolation, align_corners=self._align_corners)


Upsampler2d = partial(Upsampler, dim=2)
Upsampler3d = partial(Upsampler, dim=3)


class _WindowMax(torch.autograd.Function):
    """Max pooling with window == stride: each window reshaped onto a last axis and reduced there;
    the backward hands each gradient to its window's first maximum (as ``F.max_pool``) through a
    one-hot product, so no element is added to twice."""

    @staticmethod
    def forward(ctx, x, window):
        cut = [s // w * w for s, w in zip(x.shape[2:], window)]
        xc = x[(slice(None), slice(None)) + tuple(slice(0, c) for c in cut)]
        n, c, dim = x.shape[0], x.shape[1], len(window)
        split = [n, c] + [v for c_, w in zip(cut, window) for v in (c_ // w, w)]
        order = [0, 1] + [2 + 2 * i for i in range(dim)] + [3 + 2 * i for i in range(dim)]
        windows = xc.reshape(split).permute(order).reshape(split[0:2] + split[2::2] + [-1])
        value, index = windows.max(dim=-1)
        ctx.save_for_backward(index)
        ctx.window, ctx.shape, ctx.split, ctx.order = window, x.shape, split, order
        return value

    @staticmethod
    def backward(ctx, grad):
        index, = ctx.saved_tensors
        k = int(np.prod(ctx.window))
        onehot = index[..., None] == torch.arange(k, device=grad.device)
        g = onehot.to(grad.dtype) * grad[..., None]
        dim = len(ctx.window)
        g = g.reshape(ctx.split[0:2] + ctx.split[2::2] + ctx.split[3::2])
        g = g.permute(np.argsort(ctx.order).tolist()).reshape(ctx.split[0:2] + [
            ctx.split[2 + 2 * i] * ctx.split[3 + 2 * i] for i in range(dim)])
        pad = []
        for full, got in zip(ctx.shape[2:][::-1], g.shape[2:][::-1]):
            pad += [0, full - got]
        return F.pad(g, pad), None


def window_max_pool(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """``F.max_pool{2,3}d(x, window, window)`` whose backward adds nothing with atomics: the U-Net's
    encoder takes it for 3-D pooling under ``torch.use_deterministic_algorithms(True)``, where PyTorch
    raises on the backward of ``F.max_pool3d`` on the card. Equal to ``F.max_pool`` forward and backward."""
    return _WindowMax.apply(x, tuple(int(w) for w in window))


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
            if len(sf) == 3 and torch.are_deterministic_algorithms_enabled():
                x = window_max_pool(x, sf)
            else:
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
        """The output of every level, the deepest first."""
        outputs = []
        for block, sampler, skip in zip(self.blocks, self.samplers, skips[::-1]):
            x = sampler(x)
            x = block(torch.cat([x, self._crop(skip, x.shape[2:])], dim=1))
            outputs.append(x)
        return outputs


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
        out_channels,
        final_activation: Optional[Union[str, Callable]] = None,
        postprocessing: Optional[Union[str, Callable]] = None,
        return_side_outputs: bool = False,
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
        self.return_side_outputs = return_side_outputs
        if return_side_outputs:
            # one output conv per decoder level, the deepest first (torch-em's ``out_conv.<i>``)
            ocs = [out_channels] * len(feats) if out_channels is None or isinstance(out_channels, int) \
                else list(out_channels)
            if len(ocs) != len(feats):
                raise ValueError(f"return_side_outputs needs one out_channels per level, got {out_channels}")
            self.out_conv = nn.ModuleList([nn.Identity() if oc is None else _Conv(dim, f, oc, 1, 0)
                                           for f, oc in zip(decoder_feats, ocs)])
        else:
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
        outputs = self.decoder(self.base(h), skips)
        if self.return_side_outputs:
            # the full-resolution output first
            return [self._finalize(h, conv) for h, conv in zip(outputs, self.out_conv)][::-1]
        return self._finalize(outputs[-1], self.out_conv)

    def _finalize(self, h, out_conv):
        if out_conv is not None:
            h = out_conv(h)
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
    out_channels,
    depth: int = 4,
    initial_features: int = 32,
    gain: int = 2,
    final_activation: Optional[Union[str, Callable]] = None,
    return_side_outputs: bool = False,
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
        return_side_outputs=return_side_outputs, postprocessing=postprocessing, check_shape=check_shape,
        dtype=dtype, **conv_block_kwargs,
    )
    return _build_unet(
        UNet2d, init_kwargs, 2, in_channels, out_channels, [2] * depth, initial_features, gain,
        device, seed, final_activation=final_activation, return_side_outputs=return_side_outputs,
        postprocessing=postprocessing, check_shape=check_shape, dtype=dtype, **conv_block_kwargs,
    )


def AnisotropicUNet(
    in_channels: int,
    out_channels,
    scale_factors: List[List[int]],
    initial_features: int = 32,
    gain: int = 2,
    final_activation: Optional[Union[str, Callable]] = None,
    return_side_outputs: bool = False,
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
        return_side_outputs=return_side_outputs, anisotropic_kernel=anisotropic_kernel,
        postprocessing=postprocessing, check_shape=check_shape, dtype=dtype, **conv_block_kwargs,
    )
    return _build_unet(
        AnisotropicUNet, init_kwargs, 3, in_channels, out_channels, scale_factors,
        initial_features, gain, device, seed, final_activation=final_activation,
        return_side_outputs=return_side_outputs,
        anisotropic_kernel=anisotropic_kernel, postprocessing=postprocessing,
        check_shape=check_shape, dtype=dtype, **conv_block_kwargs,
    )


def UNet3d(
    in_channels: int,
    out_channels,
    depth: int = 4,
    initial_features: int = 32,
    gain: int = 2,
    final_activation: Optional[Union[str, Callable]] = None,
    return_side_outputs: bool = False,
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
        return_side_outputs=return_side_outputs, postprocessing=postprocessing, check_shape=check_shape,
        dtype=dtype, **conv_block_kwargs,
    )
    return _build_unet(
        UNet3d, init_kwargs, 3, in_channels, out_channels, [2] * depth, initial_features, gain,
        device, seed, final_activation=final_activation, return_side_outputs=return_side_outputs,
        postprocessing=postprocessing, check_shape=check_shape, dtype=dtype, **conv_block_kwargs,
    )
