"""Hiera, the SAM2 image encoder's trunk, with its FPN neck.

Counterpart of ``torch_em_tpu/models/hiera.py`` (``HieraSam2``,
``HIERA_CONFIGS``, ``load_sam2_weights``): a 7x7 stride-4 patch embedding, a
background position embedding resized to the grid with torch's bicubic
(``F.interpolate(mode="bicubic", align_corners=False)``, which the JAX
package reproduces by matrix on purpose) plus a tiled window embedding, four
stages of pre-norm blocks with windowed attention (global in
``global_att_blocks``), where the first block of stages 2 to ``q_pool`` + 1
max-pools its queries 2x2 (floor mode) and doubles width and heads, and a
neck of 1x1 lateral convs to ``d_model`` with a nearest 2x top-down path into
``fpn_top_down_levels``. ``scalp`` drops the coarsest level.

Call: x (N, C, H, W) -> (features (N, d_model, H / 16, W / 16), [features at H
/ 4, H / 8, H / 16]), float32; ``out_chans`` is ``d_model``. Parameters are
float32 and named as sam2's image encoder names them (``trunk.patch_embed.proj``,
``trunk.pos_embed`` (1, C, h, w), ``trunk.pos_embed_window``,
``trunk.blocks.<i>.{norm1, attn.qkv, attn.proj, proj, norm2, mlp.layers.0,
mlp.layers.1}``, ``neck.convs.<i>.conv``).
"""

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .vit import (LayerNorm, Linear, Conv2d, PatchEmbed, _attention, _window_partition, _window_unpartition,
                  at_least_f32, flax_init_, load_by_name, load_state)

__all__ = ["HieraSam2", "HIERA_CONFIGS", "load_sam2_weights"]


def _max_pool(x: torch.Tensor, stride: Tuple[int, int]) -> torch.Tensor:
    """Stride-window max pool of (B, H, W, C), floor mode (torch's ``MaxPool2d``)."""
    sh, sw = stride
    b, h, w, c = x.shape
    h2, w2 = h // sh, w // sw
    x = x[:, :h2 * sh, :w2 * sw].reshape(b, h2, sh, w2, sw, c)
    return x.amax(dim=(2, 4))


class _MultiScaleAttention(nn.Module):
    """sam2's ``MultiScaleAttention``: a joint qkv to ``dim_out``, the queries optionally
    max-pooled (keys and values stay at the input's resolution)."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, q_stride: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.dim_out, self.num_heads, self.q_stride = dim_out, num_heads, q_stride
        self.qkv = Linear(dim, 3 * dim_out)
        self.proj = Linear(dim_out, dim_out)

    def forward(self, x):
        b, h, w, _ = x.shape
        qkv = self.qkv(x.reshape(b, h * w, -1)).reshape(b, h * w, 3, self.num_heads, -1)
        q, k, v = qkv.unbind(2)  # (B, L, nH, d) each
        if self.q_stride is not None:
            q = _max_pool(q.reshape(b, h, w, self.dim_out), self.q_stride)
            h, w = q.shape[1], q.shape[2]
            q = q.reshape(b, h * w, self.num_heads, -1)
        out = _attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), None)
        return self.proj(out.transpose(1, 2).reshape(b, h, w, self.dim_out))


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.ModuleList([Linear(dim, hidden), Linear(hidden, dim)])

    def forward(self, x):
        return self.layers[1](F.gelu(self.layers[0](x)))


class _HieraBlock(nn.Module):
    """sam2's ``MultiScaleBlock``: pre-norm attention with window partition, query pooling at
    a stage transition, a linear shortcut ``proj`` where the width changes."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, window_size: int = 0,
                 q_stride: Optional[Tuple[int, int]] = None, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.q_stride = window_size, q_stride
        self.norm1 = LayerNorm(dim)
        self.proj = Linear(dim, dim_out) if dim != dim_out else None
        self.attn = _MultiScaleAttention(dim, dim_out, num_heads, q_stride)
        self.norm2 = LayerNorm(dim_out)
        self.mlp = _MLP(dim_out, int(dim_out * mlp_ratio))

    def forward(self, x):
        shortcut = x
        xn = self.norm1(x)
        if self.proj is not None:
            shortcut = self.proj(xn)
            if self.q_stride is not None:
                shortcut = _max_pool(shortcut, self.q_stride)
        ws = self.window_size
        hw = xn.shape[1], xn.shape[2]
        if ws > 0:
            xn, pad_hw = _window_partition(xn, ws)
        att = self.attn(xn)
        if self.q_stride is not None:
            # the pooled windows are window_size // stride wide and tile the pooled extent
            ws = self.window_size // self.q_stride[0]
            hw = shortcut.shape[1], shortcut.shape[2]
            pad_hw = tuple(s + ((ws - s % ws) % ws if ws > 0 else 0) for s in hw)
        if self.window_size > 0:
            att = _window_unpartition(att, ws, pad_hw, hw)
        x = shortcut + att
        return x + self.mlp(self.norm2(x))


def _hiera_block_configs(embed_dim, num_heads, stages, global_att_blocks, window_spec, q_pool, dim_mul, head_mul):
    """sam2 Hiera's schedule per block: the stage ends, query pooling in the first block of
    stages 2 to q_pool + 1, the window size lagging one block at a stage transition, width and
    heads growing by ``dim_mul`` and ``head_mul``."""
    depth = sum(stages)
    stage_ends = [sum(stages[:i + 1]) - 1 for i in range(len(stages))]
    q_pool_blocks = [x + 1 for x in stage_ends[:q_pool]]
    cur_stage, cfgs = 1, []
    for i in range(depth):
        dim_out = embed_dim
        window_size = 0 if i in (global_att_blocks or ()) else window_spec[cur_stage - 1]
        if i - 1 in stage_ends:
            dim_out = int(embed_dim * dim_mul)
            num_heads = int(num_heads * head_mul)
            cur_stage += 1
        cfgs.append(dict(dim=embed_dim, dim_out=dim_out, num_heads=num_heads, window_size=window_size,
                         q_stride=i in q_pool_blocks))
        embed_dim = dim_out
    return cfgs, stage_ends


class _Trunk(nn.Module):
    def __init__(self, in_chans, embed_dim, bkg_size, window, cfgs, q_stride, mlp_ratio):
        super().__init__()
        self.patch_embed = PatchEmbed(7, in_chans, embed_dim, stride=4, padding=3)
        self.pos_embed = nn.Parameter(torch.zeros((1, embed_dim) + tuple(bkg_size)))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, embed_dim, window, window))
        self.blocks = nn.ModuleList([
            _HieraBlock(c["dim"], c["dim_out"], c["num_heads"], c["window_size"], q_stride if c["q_stride"] else None,
                        mlp_ratio) for c in cfgs])

    def position(self, gh: int, gw: int) -> torch.Tensor:
        """The background embedding resized (torch's bicubic) to (gh, gw) plus the tiled window
        embedding, (1, gh, gw, C) float32."""
        pos = F.interpolate(self.pos_embed, size=(gh, gw), mode="bicubic", align_corners=False)
        win = self.pos_embed_window.shape[-1]
        pos = pos + self.pos_embed_window.tile(1, 1, gh // win, gw // win)
        return pos.permute(0, 2, 3, 1)


class _NeckConv(nn.Module):
    def __init__(self, in_channels, d_model):
        super().__init__()
        self.conv = Conv2d(in_channels, d_model, 1)


class _Neck(nn.Module):
    def __init__(self, channels: Sequence[int], d_model: int):
        super().__init__()
        self.convs = nn.ModuleList([_NeckConv(c, d_model) for c in channels])


class HieraSam2(nn.Module):
    """SAM2's image encoder (Hiera trunk and FPN neck); see the module's docstring."""

    def __init__(self, img_size: int = 1024, in_chans: int = 3, embed_dim: int = 96, num_heads: int = 1,
                 stages: Sequence[int] = (2, 3, 16, 3), global_att_blocks: Sequence[int] = (12, 16, 20),
                 window_pos_embed_bkg_spatial_size: Sequence[int] = (14, 14),
                 window_spec: Sequence[int] = (8, 4, 14, 7), backbone_channel_list: Sequence[int] = (768, 384, 192, 96),
                 d_model: int = 256, fpn_top_down_levels: Sequence[int] = (2, 3), scalp: int = 1, q_pool: int = 3,
                 q_stride: Tuple[int, int] = (2, 2), dim_mul: float = 2.0, head_mul: float = 2.0,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.embed_dim, self.d_model, self.dtype = img_size, embed_dim, d_model, dtype
        self.fpn_top_down_levels, self.scalp = tuple(fpn_top_down_levels), scalp
        cfgs, self.stage_ends = _hiera_block_configs(embed_dim, num_heads, stages, global_att_blocks, window_spec,
                                                     q_pool, dim_mul, head_mul)
        self.trunk = _Trunk(in_chans, embed_dim, window_pos_embed_bkg_spatial_size, window_spec[0], cfgs,
                            tuple(q_stride), mlp_ratio)
        # neck conv j reads trunk level n - j: the coarsest first, as backbone_channel_list
        self.neck = _Neck([cfgs[e]["dim_out"] for e in self.stage_ends][::-1], d_model)

    @property
    def out_chans(self) -> int:
        """The features' channels, which UNETR reads."""
        return self.d_model

    def reset_parameters_from(self, generator: torch.Generator):
        """flax's initialisers, as the JAX package's module: lecun-normal kernels, zero biases,
        unit norms, normal(0.02) position embeddings."""
        flax_init_(self, generator, [self.trunk.pos_embed, self.trunk.pos_embed_window])

    def forward(self, x):
        h = self.trunk.patch_embed(x.to(self.dtype))
        h = h + self.trunk.position(h.shape[1], h.shape[2]).to(h.dtype)
        levels = []
        for i, block in enumerate(self.trunk.blocks):
            h = block(h)
            if i in self.stage_ends:
                levels.append(h)
        n = len(levels) - 1
        outs, prev = [None] * len(levels), None
        for i in range(n, -1, -1):
            lateral = self.neck.convs[n - i].conv(levels[i].permute(0, 3, 1, 2))
            if i in self.fpn_top_down_levels and prev is not None:
                top = at_least_f32(prev).repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                lateral = lateral + top.to(lateral.dtype)
            prev = outs[i] = lateral
        if self.scalp > 0:
            outs = outs[:-self.scalp]
        feats = [at_least_f32(o) for o in outs]
        return feats[-1], feats


# the reference's configurations
HIERA_CONFIGS = {
    "hvit_t": dict(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2), global_att_blocks=(5, 7, 9),
                   window_pos_embed_bkg_spatial_size=(7, 7), backbone_channel_list=(768, 384, 192, 96)),
    "hvit_s": dict(embed_dim=96, num_heads=1, stages=(1, 2, 11, 2), global_att_blocks=(7, 10, 13),
                   window_pos_embed_bkg_spatial_size=(7, 7), backbone_channel_list=(768, 384, 192, 96)),
    "hvit_b": dict(embed_dim=112, num_heads=2, backbone_channel_list=(896, 448, 224, 112)),
    "hvit_l": dict(embed_dim=144, num_heads=2, stages=(2, 6, 36, 4), global_att_blocks=(23, 33, 43),
                   window_spec=(8, 4, 16, 8), backbone_channel_list=(1152, 576, 288, 144)),
}

# tensors of a whole sam2 model that are not its image encoder's
_NOT_ENCODER = ("mask_decoder", "prompt_encoder", "sam_", "memory_", "obj_ptr", "no_mem", "maskmem")


def load_sam2_weights(encoder: HieraSam2, checkpoint: Union[str, Dict[str, torch.Tensor]],
                      strict: bool = True) -> HieraSam2:
    """Load a SAM2 checkpoint (a whole sam2 model's, its ``image_encoder.`` entries, or a bare
    encoder's ``trunk.``/``neck.`` state dict; a path or a state dict) into ``encoder`` in
    place. The neck's parameter-free position encoding is dropped, and its convs load from
    ``neck.convs.<i>.conv.*`` or ``neck.convs.<i>.*``. With ``strict`` a tensor without a
    counterpart of its shape raises. Returns the encoder."""
    state = {}
    for k, v in load_state(checkpoint).items():
        k = k[len("image_encoder."):] if k.startswith("image_encoder.") else k
        if k.startswith(_NOT_ENCODER) or k.startswith("neck.position_encoding"):
            continue
        parts = k.split(".")
        if len(parts) == 4 and parts[:2] == ["neck", "convs"]:
            k = ".".join(parts[:3] + ["conv", parts[3]])
        state[k] = v
    load_by_name(encoder, state, "load_sam2_weights", strict)
    return encoder
