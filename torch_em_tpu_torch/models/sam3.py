"""SAM3's perception-encoder (vitdet) image encoder.

Counterpart of ``torch_em_tpu/models/sam3.py`` (``Sam3ViT``, ``SAM3_CONFIG``,
``load_sam3_weights``) at the reference's "vit_pe" configuration: 1008 px
input, patch 14 (no bias), embed 1024, depth 32, 16 heads, mlp ratio 4.625,
windows of 24 with global attention in blocks (7, 15, 23, 31), the position
table of the 336 px pretraining grid (24 x 24, its cls row dropped) tiled
across an exact-multiple grid or else resized with ``resize_linear``, a
layer norm before the blocks (``ln_pre``), axial 2-D RoPE in every attention
(consecutive channel pairs; a quarter of the angle channels turn with x, a
quarter with y; a span beyond the pretraining grid has its coordinates
scaled into it), no relative positions, no final norm, no neck.

Call: x (N, C, H, W) -> (features (N, embed_dim, H / 14, W / 14), [features
after each global block]), float32. Parameters are float32 and named as the
vitdet checkpoints name them (``patch_embed.proj``, ``pos_embed``,
``ln_pre``, ``blocks.<i>.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
mlp.fc2}``).
"""

from functools import lru_cache
from typing import Dict, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import resize_linear
from .vit import (LayerNorm, Linear, PatchEmbed, _attention, _window_partition, _window_unpartition, at_least_f32,
                  flax_init_, load_by_name, load_state)

__all__ = ["Sam3ViT", "SAM3_CONFIG", "load_sam3_weights"]

# the reference's fixed "vit_pe" configuration
SAM3_CONFIG = dict(
    img_size=1008, pretrain_img_size=336, patch_size=14, embed_dim=1024, depth=32, num_heads=16, mlp_ratio=4.625,
    window_size=24, global_attn_indexes=(7, 15, 23, 31),
)


@lru_cache(maxsize=16)
def _axial_rope_angles(gh: int, gw: int, head_dim: int, scale_h: float = 1.0, scale_w: float = 1.0,
                       theta: float = 10000.0) -> torch.Tensor:
    """Angles (gh * gw, head_dim // 2) of axial 2-D RoPE over a (gh, gw) grid: the first
    head_dim // 4 turn with the column coordinate, the rest with the row; float32, computed in
    float64 numpy as the JAX package computes them."""
    quarter = head_dim // 4
    freqs = 1.0 / (theta ** (np.arange(quarter, dtype=np.float64) * 4.0 / head_dim))
    ty, tx = np.meshgrid(np.arange(gh, dtype=np.float64) * scale_h, np.arange(gw, dtype=np.float64) * scale_w,
                         indexing="ij")
    angles = np.concatenate([tx.reshape(-1)[:, None] * freqs[None, :], ty.reshape(-1)[:, None] * freqs[None, :]], 1)
    return torch.from_numpy(angles.astype(np.float32))


def _apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Turn the consecutive channel pairs of x (..., L, d) by angles (L, d // 2), in float32."""
    xf = at_least_f32(x).reshape(*x.shape[:-1], -1, 2)
    cos, sin = torch.cos(angles)[..., None], torch.sin(angles)[..., None]
    x1, x2 = xf[..., :1], xf[..., 1:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape).to(x.dtype)


def _tile_or_resize_pos(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """vitdet's ``get_abs_pos(..., tiling=True)`` of (1, ph, pw, C): tiled across an
    exact-multiple grid, else resized linearly."""
    ph, pw = pos.shape[1], pos.shape[2]
    if (gh, gw) == (ph, pw):
        return pos
    if gh % ph == 0 and gw % pw == 0:
        return pos.tile(1, gh // ph, gw // pw, 1)
    return resize_linear(pos, (1, gh, gw, pos.shape[-1]))


class _RopeAttention(nn.Module):
    """Multi-head attention over the tokens of (B, H, W, C) with axial RoPE on queries and keys."""

    def __init__(self, dim: int, num_heads: int, pretrain_grid: int):
        super().__init__()
        self.num_heads, self.pretrain_grid = num_heads, pretrain_grid
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        b, h, w, c = x.shape
        qkv = self.qkv(x.reshape(b, h * w, c)).reshape(b, h * w, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # (B, nH, L, d) each
        angles = _axial_rope_angles(h, w, q.shape[-1], min(1.0, self.pretrain_grid / h),
                                    min(1.0, self.pretrain_grid / w)).to(x.device)
        out = _attention(_apply_rope(q, angles), _apply_rope(k, angles), v, None)
        return self.proj(out.transpose(1, 2).reshape(b, h * w, c)).reshape(b, h, w, c)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _Sam3Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, window_size: int, pretrain_grid: int):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim)
        self.attn = _RopeAttention(dim, num_heads, pretrain_grid)
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


class Sam3ViT(nn.Module):
    """SAM3's vitdet encoder; see the module's docstring."""

    def __init__(self, img_size: int = 1008, pretrain_img_size: int = 336, patch_size: int = 14, in_chans: int = 3,
                 embed_dim: int = 1024, depth: int = 32, num_heads: int = 16, mlp_ratio: float = 4.625,
                 window_size: int = 24, global_attn_indexes=(7, 15, 23, 31), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.embed_dim, self.dtype = img_size, embed_dim, dtype
        self.global_attn_indexes = tuple(global_attn_indexes)
        self.pre_grid = pretrain_img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim, bias=False)
        # the pretraining table keeps its cls row, which the encoder drops
        self.pos_embed = nn.Parameter(torch.zeros(1, self.pre_grid ** 2 + 1, embed_dim))
        self.ln_pre = LayerNorm(embed_dim)
        self.blocks = nn.ModuleList([
            _Sam3Block(embed_dim, num_heads, mlp_ratio, 0 if i in self.global_attn_indexes else window_size,
                       self.pre_grid) for i in range(depth)])

    def reset_parameters_from(self, generator: torch.Generator):
        """flax's initialisers, as the JAX package's module: lecun-normal kernels, zero biases,
        unit norms, a normal(0.02) position table."""
        flax_init_(self, generator, [self.pos_embed])

    def forward(self, x):
        h = self.patch_embed(x.to(self.dtype))
        pos = self.pos_embed[:, 1:].reshape(1, self.pre_grid, self.pre_grid, self.embed_dim)
        h = self.ln_pre(h + _tile_or_resize_pos(pos, h.shape[1], h.shape[2]).to(h.dtype))
        intermediates = []
        for i, block in enumerate(self.blocks):
            h = block(h)
            if i in self.global_attn_indexes:
                intermediates.append(at_least_f32(h.permute(0, 3, 1, 2)))
        return at_least_f32(h.permute(0, 3, 1, 2)), intermediates


def load_sam3_weights(encoder: Sam3ViT, checkpoint: Union[str, Dict[str, torch.Tensor]],
                      strict: bool = True) -> Sam3ViT:
    """Load a SAM3 vitdet checkpoint (a bare state dict or a whole model's, whose encoder
    entries sit under ``image_encoder.trunk.``, ``image_encoder.``, ``vision_encoder.``,
    ``trunk.`` or ``backbone.``; a path or a state dict) into ``encoder`` in place. The MLPs
    load from ``mlp.fc{1,2}`` or ``mlp.lin{1,2}``, the position table from any shape of its
    size. With ``strict`` a tensor without a counterpart of its shape raises. Returns the
    encoder."""
    state = load_state(checkpoint)
    for prefix in ("image_encoder.trunk.", "image_encoder.", "vision_encoder.", "trunk.", "backbone."):
        stripped = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        if stripped:
            state = stripped
            break
    state = {k.replace(".mlp.lin", ".mlp.fc"): v for k, v in state.items()}
    if "pos_embed" in state:
        state["pos_embed"] = state["pos_embed"].reshape(1, -1, state["pos_embed"].shape[-1])
    load_by_name(encoder, state, "load_sam3_weights", strict)
    return encoder
