"""SAM-geometry vision transformer, the encoder of UNETR.

Counterpart of ``torch_em_tpu/models/vit.py`` (``ViT``, ``VIT_CONFIGS``,
``get_vision_transformer``, ``load_sam_weights``). ``get_vision_transformer``
and ``load_sam_weights`` route every family of the JAX package: ``"sam2"``
to ``hiera.py``, ``"sam3"`` to ``sam3.py``, ``"dinov2"``/``"dinov3"`` to
``dino.py``, ``"mae"``/``"scalemae"`` to ``scalemae.py``. This file holds
the ``"sam"`` and ``"cellpose_sam"`` families: patch embedding, a learned
position embedding resized to the input's grid, pre-norm blocks with
windowed attention (global in the ``global_attn_indexes`` blocks),
decomposed relative positions in every attention, and segment-anything's
256-channel neck. Tensors are
channel-first at the public call, ``(N, C, H, W) -> (features,
[global-block features])``, both float32.

Parameters are float32 and named as segment-anything's image encoder names
them (``patch_embed.proj``, ``pos_embed``, ``blocks.<i>.norm1``,
``blocks.<i>.attn.qkv``, ``blocks.<i>.attn.rel_pos_h``, ``blocks.<i>.mlp.lin1``,
``neck.0`` ... ``neck.3``), so its checkpoints load by name. Layers compute
in their input's dtype: the model's ``dtype`` casts the input, as flax's
``dtype`` does. The layer norms use flax's epsilon 1e-6 and compute in
float32; the attention logits, the relative-position bias and the softmax are
float32 as in the JAX package. On a CPU tensor the attention runs as plain
products (the reference of this file's tests); on the card it runs through
``F.scaled_dot_product_attention`` with the bias in the compute dtype.
"""

import warnings
from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import resize_linear

__all__ = ["ViT", "VIT_CONFIGS", "get_vision_transformer", "load_sam_weights"]


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator, fan_in: Optional[int] = None):
    """flax's default kernel init: a normal of variance 1 / fan_in truncated at two deviations."""
    fan_in = fan_in or weight[0].numel()
    std = fan_in ** -0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 where it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters, computed in the input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype))

    def reset_parameters_from(self, generator: torch.Generator):
        lecun_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class LayerNorm(nn.LayerNorm):
    """Layer norm over the last axis as flax's: epsilon 1e-6, computed in float32,
    returned in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        xf = at_least_f32(x)
        return F.layer_norm(xf, self.normalized_shape, self.weight.to(xf.dtype), self.bias.to(xf.dtype),
                            self.eps).to(x.dtype)


class _LayerNorm2d(LayerNorm):
    """The layer norm over the channels of a channel-first map (segment-anything's neck)."""

    def forward(self, x):
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters, computed in the input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype))

    def reset_parameters_from(self, generator: torch.Generator):
        lecun_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class PatchEmbed(nn.Module):
    """Patches to embeddings: ``proj`` is a conv with kernel and stride ``patch_size`` (or
    ``stride`` and ``padding`` of their own); (N, C, H, W) -> (N, H / s, W / s, embed_dim)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int, bias: bool = True,
                 stride: Optional[int] = None, padding: int = 0):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=stride or patch_size, padding=padding, bias=bias)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


def flax_init_(module: nn.Module, generator: torch.Generator, normal: Sequence[nn.Parameter] = ()):
    """flax's initialisers, as the JAX package's modules get them: lecun-normal kernels and zero
    biases of every ``Linear`` and ``Conv2d``, unit layer norms, normal(0.02) for ``normal``."""
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d)):
            m.reset_parameters_from(generator)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
    with torch.no_grad():
        for p in normal:
            p.normal_(0.0, 0.02, generator=generator)


def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Relative position embeddings per (query, key) pair along one axis: the table is
    resized linearly to 2 * max(q, k) - 1 entries, then gathered by relative coordinate."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize_linear(rel_pos, (max_rel_dist, rel_pos.shape[1]))
    q_coords = torch.arange(q_size, dtype=torch.float32)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, dtype=torch.float32)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative.long().to(rel_pos.device)]


def _decomposed_rel_pos_bias(q, rel_pos_h, rel_pos_w, q_size, k_size):
    """The decomposed relative-position bias (B*, qh*qw, kh*kw) of float32 queries
    (B*, qh*qw, d): qT·Rh[qh, kh] + qT·Rw[qw, kw]."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = _get_rel_pos(q_h, k_h, rel_pos_h).to(q.dtype)
    rw = _get_rel_pos(q_w, k_w, rel_pos_w).to(q.dtype)
    b, _, dim = q.shape
    r_q = q.reshape(b, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    return (rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).reshape(b, q_h * q_w, k_h * k_w)


def _window_partition(x, window_size: int):
    """Pad (B, H, W, C) to window multiples and split it into (B * nW, ws, ws, C)."""
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window_size, window_size, wp // window_size, window_size, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, c)
    return windows, (hp, wp)


def _window_unpartition(windows, window_size: int, pad_hw, hw):
    """Inverse of ``_window_partition``, cropping the padding."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window_size // window_size)
    x = windows.reshape(b, hp // window_size, wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _attention_plain(q, k, v, bias):
    """softmax(q·kᵀ / sqrt(d) + bias)·v with float32 logits and softmax, as the JAX package."""
    scale = q.shape[-1] ** -0.5
    attn = torch.matmul(at_least_f32(q * scale), at_least_f32(k).transpose(-2, -1))
    if bias is not None:
        attn = attn + bias
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    return torch.matmul(attn, v)


def _attention(q, k, v, bias):
    """The attention of (B, nH, L, d) queries, keys and values with a float32 bias (B, nH, L, L):
    on the card ``F.scaled_dot_product_attention`` with the bias in the compute dtype, on
    the CPU the plain version."""
    if q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=None if bias is None else bias.to(q.dtype))
    return _attention_plain(q, k, v, bias)


class _Attention(nn.Module):
    """Multi-head attention over the tokens of (B, H, W, C), with decomposed relative positions."""

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool = False, rel_pos_size: int = 14):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * rel_pos_size - 1, self.head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * rel_pos_size - 1, self.head_dim))

    def forward(self, x):
        b, h, w, c = x.shape
        qkv = self.qkv(x.reshape(b, h * w, c)).reshape(b, h * w, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, nH, L, d) each
        bias = None
        if self.use_rel_pos:
            bias = _decomposed_rel_pos_bias(at_least_f32(q.reshape(b * self.num_heads, h * w, -1)), self.rel_pos_h,
                                            self.rel_pos_w, (h, w), (h, w)).reshape(b, self.num_heads, h * w, h * w)
        out = _attention(q, k, v, bias).transpose(1, 2).reshape(b, h * w, c)
        return self.proj(out).reshape(b, h, w, c)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = Linear(dim, hidden)
        self.lin2 = Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))  # the exact erf form, as the JAX package's


class _Block(nn.Module):
    """Pre-norm transformer block; ``window_size`` 0 attends globally."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, window_size: int = 0,
                 use_rel_pos: bool = False, rel_pos_size: int = 14):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim)
        self.attn = _Attention(dim, num_heads, use_rel_pos, rel_pos_size)
        self.norm2 = LayerNorm(dim)
        self.mlp = _MLP(dim, int(dim * mlp_ratio))

    def forward(self, x):
        h = self.norm1(x)
        if self.window_size > 0:
            hw = h.shape[1], h.shape[2]
            h, pad_hw = _window_partition(h, self.window_size)
        h = self.attn(h)
        if self.window_size > 0:
            h = _window_unpartition(h, self.window_size, pad_hw, hw)
        x = x + h
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """SAM-geometry ViT image encoder: x (N, C, H, W) -> (features (N, out_chans or
    embed_dim, H / p, W / p), [features (N, embed_dim, H / p, W / p) after each global block]),
    float32. With ``use_neck`` the neck's parameters exist; ``apply_neck=False`` returns the
    last block's features instead of the neck's, as UNETR uses them."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, in_chans: int = 3, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0, out_chans: int = 256,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11), use_neck: bool = True,
                 apply_neck: bool = True, window_size: int = 0, use_rel_pos: bool = False,
                 rel_pos_table_sizes: Optional[Sequence[int]] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.patch_size, self.embed_dim = img_size, patch_size, embed_dim
        self.global_attn_indexes = tuple(global_attn_indexes)
        self.apply_neck = apply_neck
        self.dtype = dtype
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList()
        for i in range(depth):
            is_global = i in self.global_attn_indexes
            block_window = 0 if is_global else window_size
            table = rel_pos_table_sizes[i] if rel_pos_table_sizes is not None else (block_window or grid)
            self.blocks.append(_Block(embed_dim, num_heads, mlp_ratio, block_window, use_rel_pos, table))
        self.neck = nn.Sequential(
            Conv2d(embed_dim, out_chans, 1, bias=False), _LayerNorm2d(out_chans),
            Conv2d(out_chans, out_chans, 3, padding=1, bias=False), _LayerNorm2d(out_chans),
        ) if use_neck else None

    def reset_parameters_from(self, generator: torch.Generator):
        """flax's initialisers, as the JAX package's module: lecun-normal kernels, zero
        biases and relative-position tables, unit norms, a normal(0.02) position embedding."""
        flax_init_(self, generator, [self.pos_embed])
        for m in self.modules():
            if isinstance(m, _Attention) and m.use_rel_pos:
                nn.init.zeros_(m.rel_pos_h)
                nn.init.zeros_(m.rel_pos_w)

    def forward(self, x):
        h = self.patch_embed(x.to(self.dtype))
        pos_embed = self.pos_embed
        if tuple(h.shape[1:3]) != tuple(pos_embed.shape[1:3]):
            pos_embed = resize_linear(pos_embed, (1,) + tuple(h.shape[1:3]) + (self.embed_dim,))
        h = h + pos_embed.to(h.dtype)
        intermediates = []
        for i, block in enumerate(self.blocks):
            h = block(h)
            if i in self.global_attn_indexes:
                intermediates.append(at_least_f32(h.permute(0, 3, 1, 2)))
        out = h.permute(0, 3, 1, 2)
        if self.neck is not None and self.apply_neck:
            out = self.neck(out)
        return at_least_f32(out), intermediates


VIT_CONFIGS = {
    "vit_t": dict(embed_dim=192, depth=12, num_heads=3, global_attn_indexes=(2, 5, 8, 11)),
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11)),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16, global_attn_indexes=(5, 11, 17, 23)),
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16, global_attn_indexes=(7, 15, 23, 31)),
}

BACKBONES = ("sam", "sam2", "sam3", "cellpose_sam", "mae", "scalemae", "dinov2", "dinov3")


def _config(configs: Dict[str, dict], model: str, family: str, kwargs) -> dict:
    if model not in configs:
        raise ValueError(f"'{model}' is not supported by {family}. Currently, {sorted(configs)} are supported.")
    return dict(configs[model], **kwargs)


def get_vision_transformer(backbone: str = "sam", model: str = "vit_b", img_size: int = 1024,
                           in_chans: int = 3, dtype: torch.dtype = torch.float32, **kwargs) -> nn.Module:
    """The encoder of a ``backbone`` family at configuration ``model``: ``"sam"`` (14x14
    windows, relative positions, the neck), ``"cellpose_sam"`` (vit_l at patch 8, every block
    global, SAM's 14/64 rel-pos tables resized at call time), ``"sam2"`` (``HieraSam2``,
    hvit_*), ``"sam3"`` (``Sam3ViT``, vit_pe; an ``img_size`` other than 1024 overrides its
    1008), ``"mae"`` (``MAEViT``), ``"scalemae"`` (``ScaleMAEViT``, whose input size is its
    own), ``"dinov2"``/``"dinov3"``. ``kwargs`` override the configuration. Its parameters are
    uninitialised: the factories that use it initialise them from a seed
    (``reset_parameters_from``)."""
    if backbone not in BACKBONES:
        raise ValueError(f"Unknown backbone {backbone}; available: {sorted(BACKBONES)}")
    if backbone == "sam2":
        from .hiera import HIERA_CONFIGS, HieraSam2

        return HieraSam2(img_size=img_size, in_chans=in_chans, dtype=dtype,
                         **_config(HIERA_CONFIGS, model, "SAM2", kwargs))
    if backbone in ("dinov2", "dinov3"):
        from .dino import DINOV2_CONFIGS, DINOV3_CONFIGS, DinoV2ViT, DinoV3ViT

        configs, cls = (DINOV2_CONFIGS, DinoV2ViT) if backbone == "dinov2" else (DINOV3_CONFIGS, DinoV3ViT)
        return cls(img_size=img_size, in_chans=in_chans, dtype=dtype, **_config(configs, model, backbone, kwargs))
    if backbone == "scalemae":
        from .scalemae import SCALEMAE_CONFIGS, ScaleMAEViT

        return ScaleMAEViT(in_chans=in_chans, dtype=dtype, **_config(SCALEMAE_CONFIGS, model, "scalemae", kwargs))
    if backbone == "mae":
        from .scalemae import MAE_CONFIGS, MAEViT

        return MAEViT(img_size=img_size, in_chans=in_chans, dtype=dtype, **_config(MAE_CONFIGS, model, "MAE", kwargs))
    if backbone == "sam3":
        from .sam3 import SAM3_CONFIG, Sam3ViT

        if model != "vit_pe":
            raise ValueError("'sam3' does not have multiple model configurations. "
                             "Please use 'vit_pe' as the model configuration.")
        cfg = dict(SAM3_CONFIG, **kwargs)
        if img_size != 1024:  # the reference's 1008 unless another size is asked for
            cfg["img_size"] = img_size
        return Sam3ViT(in_chans=in_chans, dtype=dtype, **cfg)
    if backbone == "cellpose_sam":
        if model != "vit_l":
            raise ValueError(f"'{model}' is not supported by CellposeSAM. Only 'vit_l' is supported.")
        cfg = dict(VIT_CONFIGS["vit_l"])
        native_grid = 1024 // 16  # SAM's pretraining grid
        cfg.update(use_neck=True, use_rel_pos=True, window_size=0, patch_size=8,
                   rel_pos_table_sizes=tuple(native_grid if i in cfg["global_attn_indexes"] else 14
                                             for i in range(cfg["depth"])))
    else:
        if model not in VIT_CONFIGS:
            raise ValueError(f"Unknown vit model {model}; available: {sorted(VIT_CONFIGS)}")
        cfg = dict(VIT_CONFIGS[model], use_neck=True, window_size=14, use_rel_pos=True)
    cfg.update(kwargs)
    return ViT(img_size=img_size, in_chans=in_chans, dtype=dtype, **cfg)


def load_state(checkpoint: Union[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """A checkpoint's tensors: ``torch.load`` of a path (on the CPU) or the given dict, out of
    a ``"model"`` or ``"state_dict"`` envelope; numpy values become tensors."""
    state = torch.load(checkpoint, map_location="cpu", weights_only=False) if isinstance(checkpoint, str) \
        else checkpoint
    for envelope in ("model", "state_dict"):
        if isinstance(state.get(envelope), dict):
            state = state[envelope]
    return {k: torch.as_tensor(v) for k, v in state.items()}


def load_by_name(module: nn.Module, state: Dict[str, torch.Tensor], what: str, strict: bool = True,
                 complete: bool = False):
    """Copy the tensors of ``state`` into ``module``'s of the same name and shape; with
    ``strict`` any other tensor raises, since the module would not compute the checkpoint's
    function, else it warns. With ``complete`` a tensor of the module that ``state`` lacks
    counts as unmatched too."""
    own = module.state_dict()
    matched = {k: v for k, v in state.items() if k in own and tuple(own[k].shape) == tuple(v.shape)}
    unmatched = sorted(set(state) - set(matched))
    if complete:
        unmatched += sorted(f"missing {k}" for k in set(own) - set(state))
    if unmatched:
        msg = f"{what}: {len(unmatched)} unmatched tensors (converted {len(matched)}), e.g. {unmatched[:5]}"
        if strict:
            raise ValueError(msg + " - the converted encoder would not reproduce the source model. "
                             "Pass strict=False to skip them anyway.")
        warnings.warn(msg)
    with torch.no_grad():
        for name, value in matched.items():
            own[name].copy_(value.to(own[name].dtype))


def load_sam_weights(encoder: nn.Module, checkpoint: Union[str, Dict[str, torch.Tensor]], backbone: str = "sam",
                     strict: bool = True) -> nn.Module:
    """Load a checkpoint (a path or a state dict) of the ``backbone`` family into ``encoder``
    in place and return the encoder: ``"sam2"`` through ``hiera.load_sam2_weights``,
    ``"sam3"`` through ``sam3.load_sam3_weights``, ``"dinov2"``/``"dinov3"`` through
    ``dino.load_dino_weights``, ``"mae"``/``"scalemae"`` through
    ``scalemae.load_mae_weights``/``load_scalemae_weights``. A segment-anything checkpoint
    (the ``image_encoder.`` entries of a whole SAM model, or an encoder's own) loads by name,
    the port's names being segment-anything's. With ``strict`` a tensor that has no
    counterpart of the same shape raises."""
    if backbone == "sam3":
        from .sam3 import load_sam3_weights

        return load_sam3_weights(encoder, checkpoint, strict=strict)
    if backbone == "sam2":
        from .hiera import load_sam2_weights

        return load_sam2_weights(encoder, checkpoint, strict=strict)
    if backbone in ("dinov2", "dinov3"):
        from .dino import load_dino_weights

        return load_dino_weights(encoder, checkpoint, backbone=backbone, strict=strict)
    if backbone == "scalemae":
        from .scalemae import load_scalemae_weights

        return load_scalemae_weights(encoder, checkpoint, strict=strict)
    if backbone == "mae":
        from .scalemae import load_mae_weights

        return load_mae_weights(encoder, checkpoint, strict=strict)
    state = load_state(checkpoint)
    state = {k.replace("image_encoder.", ""): v for k, v in state.items()
             if k.startswith("image_encoder.") or not k.startswith(("mask_decoder", "prompt_encoder"))}
    load_by_name(encoder, state, "load_sam_weights", strict)
    return encoder
