"""DINOv2 and DINOv3 vision-transformer encoders.

Counterpart of ``torch_em_tpu/models/dino.py`` (``DinoV2ViT``,
``DinoV3ViT``, ``DINOV2_CONFIGS``, ``DINOV3_CONFIGS``, ``load_dino_weights``).

DINOv2: a conv patch embedding, tokens [cls, registers, patches] (the
registers take no position embedding), a learned position embedding over
[cls + patches] whose patch part is resized to the input's grid with
``resize_cubic`` (``jax.image.resize``'s cubic), pre-norm blocks (layer norm
epsilon 1e-6, fused qkv attention, LayerScale, an MLP with the exact GELU or,
for vit_g, the fused SwiGLU ``w12``/``w3``) and a final layer norm.

DINOv3: no learned position embedding but axial RoPE over the patch centres
in [-1, 1] (on the patch tokens only; cls and storage tokens stay
unrotated), separate q/k/v/o projections with no key bias, layer norm
epsilon 1e-5, the gated SwiGLU (``gate``, ``fc1`` up, ``fc2`` down) in the
'+' models.

Both return ``(grid (N, embed_dim, H / p, W / p), [3 grids after the blocks i
with i % 3 == 2])`` in float32. Parameters are float32 and named as the
native checkpoints name them (``cls_token``, ``pos_embed``,
``register_tokens``, ``patch_embed.proj``, ``blocks.<i>.{norm1, attn.qkv,
attn.proj, ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma}``, ``norm``);
``load_dino_weights`` renames a transformers (HF) state dict to them.
"""

import re
from typing import Dict, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import resize_cubic
from .vit import LayerNorm, Linear, PatchEmbed, _attention, at_least_f32, flax_init_, load_by_name, load_state

__all__ = ["DinoV2ViT", "DinoV3ViT", "DINOV2_CONFIGS", "DINOV3_CONFIGS", "load_dino_weights"]


def _interpolate_pos_embed(pos_embed: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """The [cls + grid] position embedding with its grid part resized (cubic) to (gh, gw)."""
    n = pos_embed.shape[1] - 1
    g0 = int(round(n ** 0.5))
    if (gh, gw) == (g0, g0):
        return pos_embed
    patch = resize_cubic(pos_embed[:, 1:].reshape(1, g0, g0, -1), (1, gh, gw, pos_embed.shape[-1]))
    return torch.cat([pos_embed[:, :1], patch.reshape(1, gh * gw, -1)], dim=1)


def _rotate_patches(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE (rotate-half) of the trailing ``len(cos)`` tokens of t (B, L, nH, d)."""
    n_prefix = t.shape[1] - cos.shape[0]
    prefix, patches = t[:, :n_prefix], t[:, n_prefix:]
    p1, p2 = patches.chunk(2, dim=-1)
    rotated = torch.cat([-p2, p1], dim=-1)
    patches = patches * cos[None, :, None, :] + rotated * sin[None, :, None, :]
    return torch.cat([prefix, patches], dim=1)


class _SeqAttention(nn.Module):
    """Multi-head self attention over (B, L, C) tokens: one ``qkv`` projection (DINOv2,
    MAE) or separate ``q_proj``/``k_proj``/``v_proj``/``o_proj`` (DINOv3, ``key_bias``)."""

    def __init__(self, dim: int, num_heads: int, fused_qkv: bool = True, key_bias: bool = True):
        super().__init__()
        self.num_heads, self.fused_qkv = num_heads, fused_qkv
        if fused_qkv:
            self.qkv = Linear(dim, 3 * dim)
            self.proj = Linear(dim, dim)
        else:
            self.q_proj = Linear(dim, dim)
            self.k_proj = Linear(dim, dim, bias=key_bias)
            self.v_proj = Linear(dim, dim)
            self.o_proj = Linear(dim, dim)

    def forward(self, x, rope=None):
        b, n, dim = x.shape
        if self.fused_qkv:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q, k, v = (t.reshape(b, n, self.num_heads, -1) for t in (q, k, v))
        if rope is not None:
            q, k = _rotate_patches(q, *rope), _rotate_patches(k, *rope)
        out = _attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), None)
        out = out.transpose(1, 2).reshape(b, n, dim)
        return self.proj(out) if self.fused_qkv else self.o_proj(out)


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class _FeedForward(nn.Module):
    """``"mlp"``: fc1, exact GELU, fc2. ``"swiglu_fused"`` (DINOv2 vit_g): w12, silu(x1) * x2,
    w3, hidden 2/3 of the ratio's aligned to 8. ``"swiglu"`` (DINOv3 '+'): silu(gate) *
    fc1 (up), fc2 (down)."""

    def __init__(self, dim: int, hidden: int, ffn: str = "mlp"):
        super().__init__()
        self.ffn = ffn
        if ffn == "swiglu_fused":
            hidden = (int(hidden * 2 / 3) + 7) // 8 * 8
            self.w12 = Linear(dim, 2 * hidden)
            self.w3 = Linear(hidden, dim)
        elif ffn in ("swiglu", "mlp"):
            if ffn == "swiglu":
                self.gate = Linear(dim, hidden)
            self.fc1 = Linear(dim, hidden)
            self.fc2 = Linear(hidden, dim)
        else:
            raise ValueError(f"Invalid ffn: {ffn!r}")

    def forward(self, x):
        if self.ffn == "swiglu_fused":
            h1, h2 = self.w12(x).chunk(2, dim=-1)
            return self.w3(F.silu(h1) * h2)
        if self.ffn == "swiglu":
            return self.fc2(F.silu(self.gate(x)) * self.fc1(x))
        return self.fc2(F.gelu(self.fc1(x)))


class _DinoBlock(nn.Module):
    """Pre-norm transformer block with LayerScale (``layerscale=False``: the plain timm block
    of MAE and ScaleMAE)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, eps: float = 1e-6, fused_qkv: bool = True,
                 key_bias: bool = True, ffn: str = "mlp", layerscale: bool = True):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn = _SeqAttention(dim, num_heads, fused_qkv, key_bias)
        self.norm2 = LayerNorm(dim, eps=eps)
        self.mlp = _FeedForward(dim, int(dim * mlp_ratio), ffn)
        self.ls1 = _LayerScale(dim) if layerscale else nn.Identity()
        self.ls2 = _LayerScale(dim) if layerscale else nn.Identity()

    def forward(self, x, rope=None):
        x = x + self.ls1(self.attn(self.norm1(x), rope=rope))
        return x + self.ls2(self.mlp(self.norm2(x)))


class _TokenViT(nn.Module):
    """What the sequence encoders share: the patch embedding, a cls token, blocks, the flax
    initialisers and the grid of the patch tokens."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int, dtype: torch.dtype):
        super().__init__()
        self.patch_size, self.embed_dim, self.dtype = patch_size, embed_dim, dtype
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))

    def reset_parameters_from(self, generator: torch.Generator):
        """flax's initialisers, as the JAX package's modules: lecun-normal kernels, zero
        biases, unit norms and LayerScales, normal(0.02) tokens and position embeddings."""
        flax_init_(self, generator, [getattr(self, name) for name in ("cls_token", "register_tokens", "pos_embed")
                                     if hasattr(self, name)])
        for m in self.modules():
            if isinstance(m, _LayerScale):
                nn.init.ones_(m.gamma)

    def _tokens(self, x):
        """Patch tokens (B, gh * gw, C) in the compute dtype and the grid (gh, gw)."""
        h = self.patch_embed(x.to(self.dtype))
        b, gh, gw, c = h.shape
        return h.reshape(b, gh * gw, c), (gh, gw)

    def _prefix(self, b: int, dtype: torch.dtype) -> torch.Tensor:
        return self.cls_token.to(dtype).expand(b, 1, self.embed_dim)

    @staticmethod
    def _grid(tokens, n_prefix, grid):
        b, c = tokens.shape[0], tokens.shape[-1]
        return at_least_f32(tokens[:, n_prefix:].reshape(b, grid[0], grid[1], c).permute(0, 3, 1, 2))


class DinoV2ViT(_TokenViT):
    """DINOv2 encoder: x (N, C, H, W) -> (grid (N, embed_dim, H / p, W / p), [3 grids])."""

    def __init__(self, img_size: int = 224, patch_size: int = 14, in_chans: int = 3, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0, num_register_tokens: int = 0,
                 ffn: str = "mlp", dtype: torch.dtype = torch.float32):
        super().__init__(patch_size, in_chans, embed_dim, dtype)
        grid = img_size // patch_size
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, embed_dim))
        self.num_register_tokens = num_register_tokens
        if num_register_tokens > 0:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
        self.blocks = nn.ModuleList([_DinoBlock(embed_dim, num_heads, mlp_ratio, 1e-6, ffn=ffn)
                                     for _ in range(depth)])
        self.norm = LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x):
        tokens, grid = self._tokens(x)
        b, dtype = tokens.shape[0], tokens.dtype
        tokens = torch.cat([self._prefix(b, dtype), tokens], dim=1)
        tokens = tokens + _interpolate_pos_embed(self.pos_embed, *grid).to(dtype)
        if self.num_register_tokens > 0:
            regs = self.register_tokens.to(dtype).expand(b, -1, -1)
            tokens = torch.cat([tokens[:, :1], regs, tokens[:, 1:]], dim=1)
        n_prefix = 1 + self.num_register_tokens
        intermediates = []
        for i, block in enumerate(self.blocks):
            tokens = block(tokens)
            if i % 3 == 2 and len(intermediates) < 3:
                intermediates.append(self._grid(tokens, n_prefix, grid))
        return self._grid(self.norm(tokens), n_prefix, grid), intermediates


def _rope_tables(gh: int, gw: int, head_dim: int, base: float):
    """DINOv3's axial RoPE cos and sin tables (gh * gw, head_dim), float32, computed in numpy
    as the JAX package computes them."""
    inv_freq = 1.0 / base ** np.arange(0, 1, 4 / head_dim, dtype=np.float32)
    coords_h = (np.arange(0.5, gh, dtype=np.float32) / gh) * 2.0 - 1.0
    coords_w = (np.arange(0.5, gw, dtype=np.float32) / gw) * 2.0 - 1.0
    coords = np.stack(np.meshgrid(coords_h, coords_w, indexing="ij"), axis=-1).reshape(gh * gw, 2)
    angles = (2.0 * np.pi * coords[:, :, None] * inv_freq[None, None, :]).reshape(gh * gw, -1)
    angles = np.tile(angles, (1, 2))
    return torch.from_numpy(np.cos(angles)), torch.from_numpy(np.sin(angles))


class DinoV3ViT(_TokenViT):
    """DINOv3 encoder: x (N, C, H, W) -> (grid (N, embed_dim, H / p, W / p), [3 grids])."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, in_chans: int = 3, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0, num_register_tokens: int = 0,
                 rope_theta: float = 100.0, ffn: str = "mlp", dtype: torch.dtype = torch.float32):
        super().__init__(patch_size, in_chans, embed_dim, dtype)
        self.num_heads, self.rope_theta = num_heads, rope_theta
        self.num_register_tokens = num_register_tokens
        if num_register_tokens > 0:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
        self.blocks = nn.ModuleList([_DinoBlock(embed_dim, num_heads, mlp_ratio, 1e-5, fused_qkv=False,
                                                key_bias=False, ffn=ffn) for _ in range(depth)])
        self.norm = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        tokens, grid = self._tokens(x)
        b, dtype = tokens.shape[0], tokens.dtype
        parts = [self._prefix(b, dtype)]
        if self.num_register_tokens > 0:
            parts.append(self.register_tokens.to(dtype).expand(b, -1, -1))
        tokens = torch.cat(parts + [tokens], dim=1)
        rope = tuple(t.to(tokens.device, dtype) for t in
                     _rope_tables(*grid, self.embed_dim // self.num_heads, self.rope_theta))
        n_prefix = 1 + self.num_register_tokens
        intermediates = []
        for i, block in enumerate(self.blocks):
            tokens = block(tokens, rope=rope)
            if i % 3 == 2 and len(intermediates) < 3:
                intermediates.append(self._grid(tokens, n_prefix, grid))
        return self._grid(self.norm(tokens), n_prefix, grid), intermediates


# the public releases' configurations ('_reg4': with 4 registers, '+': gated SwiGLU)
DINOV2_CONFIGS = {
    "vit_s": dict(embed_dim=384, depth=12, num_heads=6, patch_size=14),
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12, patch_size=14),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16, patch_size=14),
    "vit_g": dict(embed_dim=1536, depth=40, num_heads=24, patch_size=14, ffn="swiglu_fused"),
}
DINOV2_CONFIGS.update({f"{name}_reg4": dict(cfg, num_register_tokens=4) for name, cfg in list(DINOV2_CONFIGS.items())})
DINOV3_CONFIGS = {
    "vit_s": dict(embed_dim=384, depth=12, num_heads=6, patch_size=16, num_register_tokens=4),
    "vit_s+": dict(embed_dim=384, depth=12, num_heads=6, patch_size=16, num_register_tokens=4, mlp_ratio=6.0,
                   ffn="swiglu"),
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12, patch_size=16, num_register_tokens=4),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16, patch_size=16, num_register_tokens=4),
    "vit_l+": dict(embed_dim=1024, depth=24, num_heads=16, patch_size=16, num_register_tokens=4, mlp_ratio=6.0,
                   ffn="swiglu"),
    "vit_h+": dict(embed_dim=1280, depth=32, num_heads=20, patch_size=16, num_register_tokens=4, mlp_ratio=6.0,
                   ffn="swiglu"),
}


def _is_hf_format(state) -> bool:
    return any(k.startswith(("embeddings.", "encoder.layer.", "layer.")) for k in state)


def _hf_to_native_dinov2(state):
    """A transformers Dinov2(WithRegisters)Model state dict under the native names, the
    per-projection q/k/v fused into ``qkv``."""
    out = {}
    for k, v in state.items():
        k = re.sub(r"^dinov2\.", "", k)
        k = k.replace("embeddings.patch_embeddings.projection", "patch_embed.proj")
        k = k.replace("embeddings.position_embeddings", "pos_embed")
        for token in ("cls_token", "mask_token", "register_tokens"):
            k = k.replace(f"embeddings.{token}", token)
        k = re.sub(r"^encoder\.layer\.(\d+)\.", r"blocks.\1.", k)
        k = k.replace("attention.output.dense", "attn.proj")
        k = k.replace("layer_scale1.lambda1", "ls1.gamma").replace("layer_scale2.lambda1", "ls2.gamma")
        k = k.replace("mlp.weights_in", "mlp.w12").replace("mlp.weights_out", "mlp.w3")
        k = re.sub(r"^layernorm\.", "norm.", k)
        out[k] = v
    for k in list(out):
        m = re.fullmatch(r"blocks\.(\d+)\.attention\.attention\.query\.(weight|bias)", k)
        if m:
            i, kind = m.groups()
            parts = [out.pop(f"blocks.{i}.attention.attention.{p}.{kind}") for p in ("query", "key", "value")]
            out[f"blocks.{i}.attn.qkv.{kind}"] = torch.cat(parts, dim=0)
    return out


def _hf_to_native_dinov3(state):
    """A transformers DINOv3ViTModel state dict under the native names."""
    out = {}
    for k, v in state.items():
        k = re.sub(r"^dinov3_vit\.", "", k)
        k = k.replace("embeddings.patch_embeddings", "patch_embed.proj")
        for token in ("cls_token", "mask_token", "register_tokens"):
            k = k.replace(f"embeddings.{token}", token)
        k = re.sub(r"^layer\.(\d+)\.", r"blocks.\1.", k)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            k = k.replace(f"attention.{proj}", f"attn.{proj}")
        k = k.replace("layer_scale1.lambda1", "ls1.gamma").replace("layer_scale2.lambda1", "ls2.gamma")
        k = k.replace("mlp.up_proj", "mlp.fc1").replace("mlp.down_proj", "mlp.fc2").replace("mlp.gate_proj", "mlp.gate")
        out[k] = v
    return out


def load_dino_weights(encoder: Union[DinoV2ViT, DinoV3ViT], checkpoint: Union[str, Dict[str, torch.Tensor]],
                      backbone: str = "dinov2", strict: bool = True):
    """Load a DINOv2 or DINOv3 checkpoint (a path or a state dict) into ``encoder`` in place:
    the native names (``blocks.<i>.attn.qkv``, ``ls1.gamma``) or a transformers state dict
    (``Dinov2Model``, ``Dinov2WithRegistersModel``, ``DINOv3ViTModel``), told apart by its
    keys. The mask token, heads, DINOv3's unused key bias and empty tensors are dropped. With
    ``strict`` a tensor without a counterpart of its shape, or a parameter the checkpoint
    lacks, raises. Returns the encoder."""
    state = load_state(checkpoint)
    if _is_hf_format(state):
        state = (_hf_to_native_dinov2 if backbone == "dinov2" else _hf_to_native_dinov3)(state)
    state = {k: v for k, v in state.items() if not k.startswith(("mask_token", "head"))
             and not k.endswith("attn.k_proj.bias") and v.numel() > 0}
    load_by_name(encoder, state, "load_dino_weights", strict, complete=True)
    return encoder
