"""MAE and ScaleMAE vision-transformer encoders.

Counterpart of ``torch_em_tpu/models/scalemae.py`` (``MAEViT``,
``ScaleMAEViT``, ``sincos_pos_embed_with_resolution``, ``MAE_CONFIGS``,
``SCALEMAE_CONFIGS``, ``load_mae_weights``, ``load_scalemae_weights``).
Both are timm ViTs with a cls token over ``dino._DinoBlock`` without
LayerScale, no final norm, and block outputs taken at the ends of the four
depth / 4 chunks.

MAE: a learned position embedding over [cls + patches], its patch part
resized with ``resize_cubic`` when the input's grid differs from
``img_size``'s; the first three chunk outputs are returned.

ScaleMAE: the input is resized (cubic) to ``input_size`` (448) and the
position embeddings are 2-D sincos tables scaled by the input pixels'
resolution, ``(W / input_size) * base_resolution``; the four chunk outputs
are returned.

Parameters are float32 and named as the timm checkpoints name them
(``cls_token``, ``pos_embed``, ``patch_embed.proj``, ``blocks.<i>.{norm1,
attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}``).
"""

from typing import Dict, Union

import numpy as np
import torch
import torch.nn as nn

from .base import resize_cubic
from .dino import _DinoBlock, _interpolate_pos_embed, _TokenViT
from .vit import at_least_f32, load_by_name, load_state

__all__ = ["MAEViT", "ScaleMAEViT", "MAE_CONFIGS", "SCALEMAE_CONFIGS", "sincos_pos_embed_with_resolution",
           "load_mae_weights", "load_scalemae_weights"]


def sincos_pos_embed_with_resolution(embed_dim: int, grid_size: int, res: torch.Tensor,
                                     cls_token: bool = True) -> torch.Tensor:
    """Resolution-scaled 2-D sincos position embeddings (n, grid_size ** 2 [+ 1], embed_dim) of
    the per-sample pixel resolutions ``res`` (n,), float32."""
    grid_1d = torch.arange(grid_size, dtype=torch.float32, device=res.device)
    gx, gy = torch.meshgrid(grid_1d, grid_1d, indexing="xy")
    grid = torch.einsum("chw,n->cnhw", torch.stack([gx, gy]), res.float())
    d = embed_dim // 2
    omega = torch.from_numpy(1.0 / 10000 ** (np.arange(d // 2, dtype=np.float32) / (d / 2.0))).to(res.device)

    def emb_1d(pos):
        out = torch.einsum("m,d->md", pos.reshape(-1), omega)
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    n = res.shape[0]
    emb = torch.cat([emb_1d(grid[0]), emb_1d(grid[1])], dim=1).reshape(n, grid_size * grid_size, embed_dim)
    if cls_token:
        emb = torch.cat([emb.new_zeros(n, 1, embed_dim), emb], dim=1)
    return emb


def _chunk_ends(depth: int):
    chunk = depth // 4
    return {chunk - 1, 2 * chunk - 1, 3 * chunk - 1, 4 * chunk - 1}


class MAEViT(_TokenViT):
    """MAE encoder: x (N, C, H, W) -> (grid (N, embed_dim, H / p, W / p), [3 grids])."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, in_chans: int = 3, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__(patch_size, in_chans, embed_dim, dtype)
        grid = img_size // patch_size
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, embed_dim))
        self.blocks = nn.ModuleList([_DinoBlock(embed_dim, num_heads, mlp_ratio, 1e-6, layerscale=False)
                                     for _ in range(depth)])

    def forward(self, x):
        tokens, grid = self._tokens(x)
        tokens = torch.cat([self._prefix(tokens.shape[0], tokens.dtype), tokens], dim=1)
        tokens = tokens + _interpolate_pos_embed(self.pos_embed, *grid).to(tokens.dtype)
        ends, intermediates = _chunk_ends(len(self.blocks)), []
        for i, block in enumerate(self.blocks):
            tokens = block(tokens)
            if i in ends and len(intermediates) < 3:
                intermediates.append(self._grid(tokens, 1, grid))
        return self._grid(tokens, 1, grid), intermediates


class ScaleMAEViT(_TokenViT):
    """ScaleMAE encoder: x (N, C, H, W) -> (grid (N, embed_dim, input_size / p, input_size / p),
    [4 grids]); ``img_size`` is kept for the configuration's sake, the input is resized to
    ``input_size``."""

    def __init__(self, img_size: int = 224, input_size: int = 448, patch_size: int = 8, in_chans: int = 3,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16, mlp_ratio: float = 4.0,
                 base_resolution: float = 2.5, dtype: torch.dtype = torch.float32):
        super().__init__(patch_size, in_chans, embed_dim, dtype)
        self.img_size, self.input_size, self.base_resolution = img_size, input_size, base_resolution
        self.blocks = nn.ModuleList([_DinoBlock(embed_dim, num_heads, mlp_ratio, 1e-6, layerscale=False)
                                     for _ in range(depth)])

    def forward(self, x):
        b, c, h_in, w_in = x.shape
        if (h_in, w_in) != (self.input_size, self.input_size):
            x = resize_cubic(at_least_f32(x), (b, c, self.input_size, self.input_size))
        tokens, grid = self._tokens(x)
        tokens = torch.cat([self._prefix(b, tokens.dtype), tokens], dim=1)
        res = torch.full((b,), (w_in / self.input_size) * self.base_resolution, device=x.device)
        tokens = tokens + sincos_pos_embed_with_resolution(self.embed_dim, grid[0], res).to(tokens.dtype)
        ends, intermediates = _chunk_ends(len(self.blocks)), []
        for i, block in enumerate(self.blocks):
            tokens = block(tokens)
            if i in ends:
                intermediates.append(self._grid(tokens, 1, grid))
        return self._grid(tokens, 1, grid), intermediates


SCALEMAE_CONFIGS = {  # every ScaleMAE model has patch 8
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12, patch_size=8),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16, patch_size=8),
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16, patch_size=8),
}
MAE_CONFIGS = {  # vit_h has patch 14
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12, patch_size=16),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16, patch_size=16),
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16, patch_size=14),
}

# tensors of the timm checkpoints that neither encoder computes with: the decoder, the mask
# token, the trailing norms, classification heads (and ScaleMAE's learned position embedding)
_UNUSED = ("mask_token", "norm.", "fc_norm", "head", "decoder_")


def load_scalemae_weights(encoder: ScaleMAEViT, checkpoint: Union[str, Dict[str, torch.Tensor]],
                          strict: bool = True) -> ScaleMAEViT:
    """Load a ScaleMAE checkpoint (timm layout; a path or a state dict) into ``encoder`` in
    place, without its unused tensors and its learned ``pos_embed`` (the encoder's position
    embeddings are functional). With ``strict`` a tensor without a counterpart of its shape,
    or a parameter the checkpoint lacks, raises. Returns the encoder."""
    state = {k: v for k, v in load_state(checkpoint).items() if not k.startswith(_UNUSED + ("pos_embed",))}
    load_by_name(encoder, state, "load_scalemae_weights", strict, complete=True)
    return encoder


def load_mae_weights(encoder: MAEViT, checkpoint: Union[str, Dict[str, torch.Tensor]],
                     strict: bool = True) -> MAEViT:
    """Load an MAE checkpoint (facebookresearch/mae's pretraining or fine-tuning layout; a
    path or a state dict) into ``encoder`` in place, its learned ``pos_embed`` included, which
    must have the encoder's shape (build the encoder with the checkpoint's ``img_size``).
    Unused tensors are dropped; ``strict`` as in ``load_scalemae_weights``."""
    state = {k: v for k, v in load_state(checkpoint).items() if not k.startswith(_UNUSED)}
    if "pos_embed" in state and tuple(state["pos_embed"].shape) != tuple(encoder.pos_embed.shape):
        raise ValueError(f"pos_embed shape {tuple(state['pos_embed'].shape)} does not match the model "
                         f"({tuple(encoder.pos_embed.shape)}); build the encoder with the checkpoint's img_size.")
    load_by_name(encoder, state, "load_mae_weights", strict, complete=True)
    return encoder
