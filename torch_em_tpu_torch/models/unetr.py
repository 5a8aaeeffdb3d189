"""UNETR: a vision-transformer encoder with a convolutional decoder, in 2D and 3D.

Counterpart of ``torch_em_tpu/models/unetr.py``. ``UNETR`` (= ``UNETR2D``)
repeats a one-channel input to the encoder's three, resizes it to
``img_size`` with ``resize_input``, optionally normalises it with the
pretrained encoders' statistics, and decodes the encoder's features through
a deconvolution pyramid (z9 / z6 / z3 from the global blocks' features and
z0 from the input with ``use_skip_connection``; else a chain from the last
features) and a decoder whose skips are centre-cropped along the channels to
the upsampled features' width, as torch-em's decoder crops every axis. The
masks are resized back to the input's size. ``UNETR3D`` runs the encoder
on every z-slice and decodes in 3-D with (1, 2, 2) upsampling and
``DepthStripPooling`` gates.

Parameters are float32, computed in the model's ``dtype`` (bfloat16 under a
trainer's ``mixed_precision``); the output is float32. ``UNETR``'s names are
torch-em's (``encoder.*`` segment-anything's, ``deconv1.block.{0.conv,1.block,2}``,
``base.block.{1,4}``, ``decoder.blocks.<i>``, ``decoder.samplers.<i>.conv``,
``deconv_out.conv``, ``decoder_head``, ``out_conv``); ``utils.convert``
carries the JAX package's weights over. The factories record their
arguments in ``model.init_kwargs`` and their path in ``model.factory``.
"""

from typing import Optional, Union

import numpy as np
import torch
import torch.nn as nn

from .base import get_activation, resize_linear, resolve_device
from .unet import BatchNorm, ConvBlock, Upsampler, _Conv
from .hiera import HieraSam2
from .vit import ViT, at_least_f32, get_vision_transformer, load_sam_weights

__all__ = ["UNETR", "UNETR2D", "UNETRModule", "UNETR3D", "UNETR3DModule", "DepthStripPooling"]

# normalisation statistics of the pretrained encoder families
_SAM_MEAN = np.array([123.675, 116.28, 103.53]) / 255.0
_SAM_STD = np.array([58.395, 57.12, 57.375]) / 255.0
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
_IMAGENET_STD = np.array([0.229, 0.224, 0.225])


def encoder_channels(encoder: nn.Module) -> int:
    """The channels of an encoder's features: a SAM-family ViT's neck where it applies it, a
    Hiera's ``d_model``, else its ``embed_dim``."""
    if isinstance(encoder, HieraSam2):
        return encoder.out_chans
    if isinstance(encoder, ViT) and encoder.neck is not None and encoder.apply_neck:
        return encoder.neck[0].out_channels
    return encoder.embed_dim


def _normalize(x, mean, std):
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device).reshape(shape)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device).reshape(shape)
    return (x - mean) / std


class _SingleConv(nn.Module):
    """One 3x3 conv, held as torch-em's ``SingleConv2DBlock.block``."""

    def __init__(self, in_channels, out_channels, dim=2):
        super().__init__()
        self.block = _Conv(dim, in_channels, out_channels, 3, 1)

    def forward(self, x):
        return self.block(x)


class _DeconvBlock(nn.Module):
    """torch-em's ``Deconv2DBlock``: 2x upsampler (1x1 conv, then linear interpolation), a 3x3
    conv, flax-semantics batch norm, ReLU (``block.0`` ... ``block.3``)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.block = nn.Sequential(Upsampler(in_channels, out_channels, 2, 2),
                                   _SingleConv(out_channels, out_channels), BatchNorm(out_channels), nn.ReLU())

    def forward(self, x):
        return self.block(x)


class _Decoder(nn.Module):
    """Upsample, concatenate the skip (its channels centre-cropped to the upsampled
    features' count where it has more), conv block; per level."""

    def __init__(self, blocks, samplers):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.samplers = nn.ModuleList(samplers)

    def forward(self, h, skips):
        for sampler, block, skip in zip(self.samplers, self.blocks, skips):
            h = sampler(h)
            if skip.shape[1] > h.shape[1]:
                off = (skip.shape[1] - h.shape[1]) // 2
                skip = skip[:, off:off + h.shape[1]]
            h = block(torch.cat([h, skip], dim=1))
        return h


class UNETRModule(nn.Module):
    """The 2-D UNETR on channel-first (N, C, H, W) tensors around ``encoder``: an encoder of
    ``get_vision_transformer`` (a SAM-family ViT with ``apply_neck=False``, as ``UNETR`` builds
    it) or another with the same call, such as the ViM of ``get_vimunet_model``."""

    def __init__(self, encoder: nn.Module, img_size: int = 1024, out_channels: int = 1, use_sam_stats: bool = False,
                 use_mae_stats: bool = False, use_dino_stats: bool = False, resize_input: bool = True,
                 final_activation=None, use_skip_connection: bool = True, initial_features: int = 64, depth: int = 3,
                 in_chans: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.in_chans, self.out_channels = img_size, in_chans, out_channels
        self.use_sam_stats, self.use_mae_stats, self.use_dino_stats = use_sam_stats, use_mae_stats, use_dino_stats
        self.resize_input, self.use_skip_connection = resize_input, use_skip_connection
        self.final_activation = get_activation(final_activation)
        self.encoder = encoder
        self.dtype = dtype
        embed = encoder_channels(encoder)
        feats = [initial_features * 2 ** i for i in range(depth + 1)][::-1]
        self.deconv1 = _DeconvBlock(embed, feats[0])
        if use_skip_connection:
            self.deconv2 = nn.Sequential(_DeconvBlock(embed, feats[0]), _DeconvBlock(feats[0], feats[1]))
            self.deconv3 = nn.Sequential(_DeconvBlock(embed, feats[0]), _DeconvBlock(feats[0], feats[1]),
                                         _DeconvBlock(feats[1], feats[2]))
            self.deconv4 = ConvBlock(in_chans, feats[-1], dim=2)
        else:
            self.deconv2 = _DeconvBlock(feats[0], feats[1])
            self.deconv3 = _DeconvBlock(feats[1], feats[2])
            self.deconv4 = _DeconvBlock(feats[2], feats[-1])
        self.base = ConvBlock(embed, feats[0], dim=2)
        # the skips z9, z6, z3 have feats[0], feats[1], feats[2] channels in either wiring
        self.decoder = _Decoder(
            [ConvBlock(f + min(s, f), f, dim=2) for s, f in zip(feats[:-1], feats[1:])],
            [Upsampler(cin, f, 2, 2) for cin, f in zip(feats[:-1], feats[1:])],
        )
        self.deconv_out = Upsampler(feats[-1], feats[-1], 2, 2)
        self.decoder_head = ConvBlock(2 * feats[-1], feats[-1], dim=2)
        self.out_conv = _Conv(2, feats[-1], out_channels, 1, 0)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype, the encoder's too (a trainer's ``mixed_precision`` sets it)."""
        return self._dtype

    @dtype.setter
    def dtype(self, value: torch.dtype):
        self._dtype = value
        if "encoder" in self._modules:
            self.encoder.dtype = value

    def _preprocess(self, x):
        """Channel repeat, resize to ``img_size``, pretrained statistics; float32."""
        x = at_least_f32(x)
        if x.shape[1] == 1 and self.in_chans == 3:
            x = x.repeat(1, 3, 1, 1)
        original_shape = tuple(x.shape[-2:])
        if self.resize_input and original_shape != (self.img_size, self.img_size):
            x = resize_linear(x, tuple(x.shape[:2]) + (self.img_size, self.img_size))
        if self.use_sam_stats:
            x = _normalize(x, _SAM_MEAN, _SAM_STD)
        elif self.use_mae_stats or self.use_dino_stats:
            x = _normalize(x, _IMAGENET_MEAN, _IMAGENET_STD)
        return x, original_shape

    def forward(self, x):
        x, original_shape = self._preprocess(x)
        z12, from_encoder = self.encoder(x.to(self.dtype))
        z12 = z12.to(self.dtype)
        if self.use_skip_connection:
            from_encoder = [f.to(self.dtype) for f in from_encoder[::-1]]
            z9 = self.deconv1(from_encoder[0])
            z6 = self.deconv2(from_encoder[1])
            z3 = self.deconv3(from_encoder[2])
            z0 = self.deconv4(x.to(self.dtype))
        else:
            z9 = self.deconv1(z12)
            z6 = self.deconv2(z9)
            z3 = self.deconv3(z6)
            z0 = self.deconv4(z3)
        h = self.decoder(self.base(z12), [z9, z6, z3])
        h = self.deconv_out(h)
        if z0.shape[2:] != h.shape[2:]:
            z0 = resize_linear(z0, tuple(z0.shape[:2]) + tuple(h.shape[2:]))
        h = self.decoder_head(torch.cat([h, z0], dim=1))
        out = at_least_f32(self.out_conv(h))
        if self.final_activation is not None:
            out = self.final_activation(out)
        if tuple(out.shape[-2:]) != original_shape:
            out = resize_linear(out, tuple(out.shape[:2]) + original_shape)
        return out


def _init_decoder(model: nn.Module, generator: torch.Generator):
    """torch's default conv init for every decoder conv, in module order."""
    for name, m in model.named_modules():
        if isinstance(m, _Conv) and not name.startswith("encoder."):
            m.reset_parameters(generator)


def _place(model: nn.Module, factory, init_kwargs, device):
    model.factory = f"{factory.__module__}.{factory.__qualname__}"
    model.init_kwargs = {**init_kwargs, "device": str(device)}
    return model.to(resolve_device(device)).eval()


def UNETR(
    img_size: int = 1024,
    backbone: str = "sam",
    encoder: Union[str, None] = "vit_b",
    decoder=None,
    out_channels: int = 1,
    use_sam_stats: bool = False,
    use_mae_stats: bool = False,
    use_dino_stats: bool = False,
    resize_input: bool = True,
    encoder_checkpoint: Optional[str] = None,
    final_activation: Optional[str] = None,
    use_skip_connection: bool = True,
    embed_dim: Optional[int] = None,
    use_conv_transpose: bool = False,
    in_chans: int = 3,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    **encoder_kwargs,
) -> UNETRModule:
    """A 2-D UNETR with the ``encoder`` model of the ``backbone`` family, initialised from
    ``seed``; with ``encoder_checkpoint`` the encoder then loads that family's checkpoint
    (``vit.load_sam_weights``).
    ``decoder``, ``embed_dim`` and ``use_conv_transpose`` are accepted as the JAX package
    accepts them, and unused; ``encoder_kwargs`` override the encoder's configuration
    (e.g. ``depth``, ``embed_dim`` of a small test model)."""
    init_kwargs = dict(
        img_size=img_size, backbone=backbone, encoder=encoder, out_channels=out_channels,
        use_sam_stats=use_sam_stats, use_mae_stats=use_mae_stats, use_dino_stats=use_dino_stats,
        resize_input=resize_input, encoder_checkpoint=encoder_checkpoint, final_activation=final_activation,
        use_skip_connection=use_skip_connection, in_chans=in_chans, dtype=dtype, seed=seed, **encoder_kwargs,
    )
    # UNETR reads a SAM-family ViT's last block's features, not its neck's (whose parameters exist)
    extra = {"apply_neck": False} if backbone in ("sam", "cellpose_sam") else {}
    vit = get_vision_transformer(backbone, encoder or "vit_b", img_size=img_size, in_chans=in_chans,
                                 **extra, **encoder_kwargs)
    model = UNETRModule(
        vit, img_size=img_size, out_channels=out_channels, use_sam_stats=use_sam_stats, use_mae_stats=use_mae_stats,
        use_dino_stats=use_dino_stats, resize_input=resize_input, final_activation=final_activation,
        use_skip_connection=use_skip_connection, in_chans=in_chans, dtype=dtype,
    )
    generator = torch.Generator().manual_seed(seed)
    vit.reset_parameters_from(generator)
    _init_decoder(model, generator)
    if encoder_checkpoint is not None:
        load_sam_weights(vit, encoder_checkpoint, backbone=backbone)
    return _place(model, UNETR, init_kwargs, device)


UNETR2D = UNETR


class DepthStripPooling(nn.Module):
    """Strip pooling along depth: the mean over Z, a 1x1x1 conv, batch norm, ReLU and a 1x1x1
    conv give a sigmoid gate, and x * gate + x returns; a no-op for Z == 1. Channel-first
    (N, C, Z, H, W)."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        hidden = max(1, channels // reduction)
        self.conv1 = _Conv(3, channels, hidden, 1, 0)
        self.bn1 = BatchNorm(hidden)
        self.conv2 = _Conv(3, hidden, channels, 1, 0)

    def forward(self, x):
        if x.shape[2] == 1:
            return x
        feat = torch.relu(self.bn1(self.conv1(x.mean(dim=2, keepdim=True))))
        return x * torch.sigmoid(self.conv2(feat)) + x


class _ConvBlock3dWithStrip(nn.Module):
    def __init__(self, in_channels, out_channels, use_strip_pooling=True):
        super().__init__()
        self.conv = ConvBlock(in_channels, out_channels, dim=3)
        self.strip = DepthStripPooling(out_channels) if use_strip_pooling else None

    def forward(self, x):
        x = self.conv(x)
        return x if self.strip is None else self.strip(x)


class _Deconv3DBlock(nn.Module):
    """(1, 2, 2) upsampler, then a 3-D conv block with strip pooling."""

    def __init__(self, in_channels, out_channels, use_strip_pooling=True):
        super().__init__()
        self.up = Upsampler(in_channels, out_channels, (1, 2, 2), 3)
        self.conv = _ConvBlock3dWithStrip(out_channels, out_channels, use_strip_pooling)

    def forward(self, x):
        return self.conv(self.up(x))


class UNETR3DModule(nn.Module):
    """UNETR3D on channel-first (N, C, Z, H, W): ``encoder`` (of any family, a SAM ViT with its
    neck) on every z-slice, a 3-D decoder with depth strip pooling, the masks resized back to
    the input's size."""

    def __init__(self, encoder: nn.Module, img_size: int = 1024, out_channels: int = 1, use_sam_stats: bool = False,
                 resize_input: bool = True, final_activation=None, use_strip_pooling: bool = True,
                 initial_features: int = 64, depth: int = 3, in_chans: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.in_chans, self.out_channels = img_size, in_chans, out_channels
        self.use_sam_stats, self.resize_input = use_sam_stats, resize_input
        self.final_activation = get_activation(final_activation)
        self.encoder = encoder
        self.dtype = dtype
        enc_channels = encoder_channels(encoder)
        feats = [initial_features * 2 ** i for i in range(depth + 1)][::-1]
        sp = use_strip_pooling
        self.deconv1 = _Deconv3DBlock(enc_channels, feats[0], sp)
        self.deconv2 = _Deconv3DBlock(feats[0], feats[1], sp)
        self.deconv3 = _Deconv3DBlock(feats[1], feats[2], sp)
        self.deconv4 = _Deconv3DBlock(feats[2], feats[3], sp)
        self.base = _ConvBlock3dWithStrip(enc_channels, feats[0], sp)
        self.samplers = nn.ModuleList([Upsampler(cin, f, (1, 2, 2), 3) for cin, f in zip(feats[:-1], feats[1:])])
        # the 3-D decoder concatenates its skips uncropped
        self.decoders = nn.ModuleList([_ConvBlock3dWithStrip(f + s, f, sp)
                                       for f, s in zip(feats[1:], feats[:-1])])
        self.deconv_out = _Deconv3DBlock(feats[-1], feats[-1], sp)
        self.decoder_head = _ConvBlock3dWithStrip(2 * feats[-1], feats[-1], sp)
        self.out_conv = _Conv(3, feats[-1], out_channels, 1, 0)

    dtype = UNETRModule.dtype

    def forward(self, x):
        x = at_least_f32(x)
        n, c, z, h, w = x.shape
        original_shape = (z, h, w)
        if c == 1 and self.in_chans == 3:
            x = x.repeat(1, 3, 1, 1, 1)
        if self.resize_input and (h, w) != (self.img_size, self.img_size):
            x = resize_linear(x, tuple(x.shape[:3]) + (self.img_size, self.img_size))
        if self.use_sam_stats:
            x = _normalize(x, _SAM_MEAN, _SAM_STD)
        # every z-slice through the shared encoder, as one batch
        slices = x.to(self.dtype).permute(0, 2, 1, 3, 4).reshape((n * z,) + tuple(x.shape[1:2] + x.shape[3:]))
        feat, _ = self.encoder(slices)
        curr = feat.reshape((n, z) + tuple(feat.shape[1:])).permute(0, 2, 1, 3, 4).to(self.dtype)

        z9 = self.deconv1(curr)
        z6 = self.deconv2(z9)
        z3 = self.deconv3(z6)
        z0 = self.deconv4(z3)
        hdec = self.base(curr)
        for sampler, decoder, skip in zip(self.samplers, self.decoders, [z9, z6, z3]):
            hdec = decoder(torch.cat([sampler(hdec), skip], dim=1))
        hdec = self.deconv_out(hdec)
        if z0.shape[2:] != hdec.shape[2:]:
            z0 = resize_linear(z0, tuple(z0.shape[:2]) + tuple(hdec.shape[2:]))
        hdec = self.decoder_head(torch.cat([hdec, z0], dim=1))
        out = at_least_f32(self.out_conv(hdec))
        if self.final_activation is not None:
            out = self.final_activation(out)
        if tuple(out.shape[-3:]) != original_shape:
            out = resize_linear(out, tuple(out.shape[:2]) + original_shape)
        return out


def UNETR3D(
    img_size: int = 1024,
    backbone: str = "sam",
    encoder: Union[str, None] = "vit_b",
    decoder=None,
    out_channels: int = 1,
    use_sam_stats: bool = False,
    resize_input: bool = True,
    encoder_checkpoint: Optional[str] = None,
    final_activation: Optional[str] = None,
    use_skip_connection: bool = False,
    embed_dim: Optional[int] = None,
    use_conv_transpose: bool = False,
    use_strip_pooling: bool = True,
    in_chans: int = 3,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    **encoder_kwargs,
) -> UNETR3DModule:
    """A 3-D UNETR: a shared encoder of the ``backbone`` family per z-slice and a 3-D decoder
    with depth strip pooling, initialised from ``seed``. It has no skip connections, as the
    reference."""
    if use_skip_connection:
        raise NotImplementedError("UNETR3D does not support skip connections (reference parity).")
    init_kwargs = dict(
        img_size=img_size, backbone=backbone, encoder=encoder, out_channels=out_channels,
        use_sam_stats=use_sam_stats, resize_input=resize_input, encoder_checkpoint=encoder_checkpoint,
        final_activation=final_activation, use_strip_pooling=use_strip_pooling, in_chans=in_chans,
        dtype=dtype, seed=seed, **encoder_kwargs,
    )
    vit = get_vision_transformer(backbone, encoder or "vit_b", img_size=img_size, in_chans=in_chans,
                                 **encoder_kwargs)
    model = UNETR3DModule(vit, img_size=img_size, out_channels=out_channels, use_sam_stats=use_sam_stats,
                          resize_input=resize_input, final_activation=final_activation,
                          use_strip_pooling=use_strip_pooling, in_chans=in_chans, dtype=dtype)
    generator = torch.Generator().manual_seed(seed)
    vit.reset_parameters_from(generator)
    _init_decoder(model, generator)
    if encoder_checkpoint is not None:
        load_sam_weights(vit, encoder_checkpoint, backbone=backbone)
    return _place(model, UNETR3D, init_kwargs, device)
