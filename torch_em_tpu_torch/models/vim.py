"""Vision Mamba encoder and ViM-UNet.

Counterpart of ``torch_em_tpu/models/vim.py``: ``ViM`` embeds patches and runs
bidirectional Mamba layers over the token sequence; ``get_vimunet_model``
plugs it into the UNETR decoder without skip connections and without input
resizing. Two layer variants, as in the JAX package:

- ``"hustvl"`` (the default): hustvl/Vim's bimamba-v2 layer
  (``BiMambaMixerV2``): RMSNorm pre-norm with the (hidden, residual)
  threading of mamba's ``Block`` (the residual in float32), separate
  backward-direction conv / x_proj / dt_proj / A / D, a dt-rank bottleneck,
  the two directions' outputs halved; a cls token in the middle of the
  sequence and the reference's drop of token 0 after the final norm. The
  parameters carry hustvl/Vim's names (``layers.<i>.mixer.in_proj``,
  ``conv1d_b``, ``x_proj_b``, ``A_b_log``, ``D_b``, ``norm_f``), so its
  checkpoints load by name (``load_vim_weights``).
- ``"native"``: the JAX package's ``MambaBlock`` (layer norm, one set of
  direction parameters, a scalar step size), no cls token.

The selective scan (S6) runs in plain torch as the JAX package's
``lax.associative_scan`` runs it: the recursive odd/even parallel prefix,
whose depth is log2 of the sequence length. B, C, the step size and the
input enter it in float32 whatever the compute dtype.
"""

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import resize_linear
from .vit import Conv2d, LayerNorm, Linear, PatchEmbed, at_least_f32, lecun_normal_, load_by_name

__all__ = ["MambaBlock", "BiMambaMixerV2", "ViM", "VIM_CONFIGS", "get_vim_encoder", "get_vimunet_model",
           "load_vim_weights"]


def _scan_states(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """The states h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along ``axis``: ``lax.associative_scan``'s
    recursion with the combine (a_l a_r, a_r b_l + b_r). Pairs of neighbours are combined and
    the half-length sequence is scanned recursively (the odd states); each even state is its
    element combined with the odd state before it. The products of the a's are the inputs of
    the recursion only: no state needs them, so they are not interleaved back."""
    n = a.shape[axis]
    if n < 2:
        return b

    def every_other(t, start, stop=None):
        index = [slice(None)] * t.ndim
        index[axis] = slice(start, stop, 2)
        return t[tuple(index)]

    a_even, a_odd = every_other(a, 0, n - 1), every_other(a, 1)
    odd = _scan_states(a_even * a_odd, torch.addcmul(every_other(b, 1), a_odd, every_other(b, 0, n - 1)), axis)
    n_even_rest = (n - 1) // 2  # even states after the first
    even_rest = torch.addcmul(every_other(b, 2), every_other(a, 2), odd.narrow(axis, 0, n_even_rest))
    out = torch.empty_like(b)
    out.narrow(axis, 0, 1).copy_(b.narrow(axis, 0, 1))
    every_other(out, 2).copy_(even_rest)
    every_other(out, 1).copy_(odd)
    return out


def _selective_scan(u, delta, A, B, C, D):
    """The S6 scan, batched over leading axes: u, delta (*, L, E); A (*, E, N); B, C (*, L, N);
    D (*, E); the leading axes of A and D broadcast against the others'.

    h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t;  y_t = C_t h_t + D u_t."""
    d_a = torch.exp(delta.unsqueeze(-1) * A.unsqueeze(-3))           # (*, L, E, N)
    d_bu = (delta * u).unsqueeze(-1) * B.unsqueeze(-2)               # (*, L, E, N)
    h = _scan_states(d_a, d_bu, d_a.ndim - 3)
    y = torch.matmul(h, C.unsqueeze(-1)).squeeze(-1)                  # (*, L, E)
    return y + u * D.unsqueeze(-2)


class RMSNorm(nn.Module):
    """RMS norm over the last axis in float32 (flax's ``RMSNorm``, epsilon 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = at_least_f32(x)
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * self.weight.to(x.dtype)


class _CausalConv1d(nn.Conv1d):
    """Depthwise conv along the sequence of (B, L, E), padded on the left (causal); weight
    (E, 1, K) as torch's, float32, computed in the input's dtype."""

    def __init__(self, channels: int, width: int, bias: bool = True):
        super().__init__(channels, channels, width, groups=channels, bias=bias)

    def forward(self, x):
        x = F.pad(x.transpose(1, 2), (self.kernel_size[0] - 1, 0))
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv1d(x, self.weight.to(x.dtype), bias, groups=self.groups).transpose(1, 2)


def _a_log(channels: int, state_dim: int) -> nn.Parameter:
    """S4D-real init: A = -[1, ..., N] per channel, stored as log(-A)."""
    return nn.Parameter(torch.log(torch.arange(1, state_dim + 1, dtype=torch.float32)).repeat(channels, 1))


class _MambaMixer(nn.Module):
    """hustvl/Vim's ``Mamba(bimamba_type="v2", if_divide_out=True)`` on (B, L, dim)."""

    def __init__(self, dim: int, state_dim: int = 16, expand: int = 2, conv_width: int = 4):
        super().__init__()
        e = dim * expand
        self.state_dim, self.dt_rank = state_dim, -(-dim // 16)  # mamba's dt_rank="auto"
        self.in_proj = Linear(dim, 2 * e, bias=False)
        self.out_proj = Linear(e, dim, bias=False)
        for suffix in ("", "_b"):
            setattr(self, f"conv1d{suffix}", _CausalConv1d(e, conv_width))
            setattr(self, f"x_proj{suffix}", Linear(e, self.dt_rank + 2 * state_dim, bias=False))
            setattr(self, f"dt_proj{suffix}", Linear(self.dt_rank, e))
        self.A_log, self.A_b_log = _a_log(e, state_dim), _a_log(e, state_dim)
        self.D, self.D_b = nn.Parameter(torch.ones(e)), nn.Parameter(torch.ones(e))

    def _scan_inputs(self, u, suffix):
        """Causal conv -> silu -> the input-dependent step size, B and C of one direction."""
        u = F.silu(getattr(self, f"conv1d{suffix}")(u))
        dt_low, B, C = torch.split(getattr(self, f"x_proj{suffix}")(u),
                                   [self.dt_rank, self.state_dim, self.state_dim], dim=-1)
        delta = F.softplus(getattr(self, f"dt_proj{suffix}")(dt_low).float())
        return at_least_f32(u), delta, at_least_f32(B), at_least_f32(C)

    def forward(self, h):
        xs, z = self.in_proj(h).chunk(2, dim=-1)
        # the backward direction runs its own pipeline on the flipped sequence; both scan as one batch
        u, delta, B, C = (torch.stack(pair) for pair in zip(self._scan_inputs(xs, ""),
                                                             self._scan_inputs(xs.flip(1), "_b")))
        A = -torch.exp(torch.stack([self.A_log, self.A_b_log]))[:, None]  # (2, 1, E, N)
        D = torch.stack([self.D, self.D_b])[:, None]                      # (2, 1, E)
        y = _selective_scan(u, delta, A, B, C, D).to(h.dtype)
        y = (y[0] + y[1].flip(1)) / 2  # if_divide_out
        return self.out_proj(y * F.silu(z))


class BiMambaMixerV2(nn.Module):
    """One hustvl/Vim layer, mamba's ``Block``: ``(hidden, residual) -> (hidden, residual)`` with
    ``residual_out = residual_in + hidden_in`` in float32 and ``hidden_out =
    mixer(norm(residual_out))`` in the compute dtype (the hidden input's)."""

    def __init__(self, dim: int, state_dim: int = 16, expand: int = 2, conv_width: int = 4):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.mixer = _MambaMixer(dim, state_dim, expand, conv_width)

    def forward(self, hidden, residual=None):
        residual = at_least_f32(hidden) if residual is None else residual + at_least_f32(hidden)
        return self.mixer(self.norm(residual).to(hidden.dtype)), residual


class MambaBlock(nn.Module):
    """The JAX package's native bidirectional Mamba block on (B, L, dim): layer norm, one set
    of direction parameters (the conv on the forward sequence only), a scalar step size."""

    def __init__(self, dim: int, state_dim: int = 16, expand: int = 2, conv_width: int = 4):
        super().__init__()
        e = dim * expand
        self.state_dim = state_dim
        self.norm = LayerNorm(dim)
        self.in_proj = Linear(dim, 2 * e)
        self.conv1d = _CausalConv1d(e, conv_width, bias=False)
        self.x_proj = Linear(e, 2 * state_dim + 1)
        self.dt_bias = nn.Parameter(torch.zeros(1))
        self.A_log = _a_log(e, state_dim)
        self.D = nn.Parameter(torch.ones(e))
        self.out_proj = Linear(e, dim)

    def forward(self, x):
        xs, z = self.in_proj(self.norm(x)).chunk(2, dim=-1)
        xs = F.silu(self.conv1d(xs))
        bc_dt = at_least_f32(self.x_proj(xs))
        B, C = bc_dt[..., :self.state_dim], bc_dt[..., self.state_dim:2 * self.state_dim]
        delta = F.softplus(bc_dt[..., -1:] + self.dt_bias).expand(xs.shape)
        u = at_least_f32(xs)
        # forward and backward directions as one batch; the backward one on the flipped sequences
        y = _selective_scan(torch.stack([u, u.flip(1)]), torch.stack([delta, delta.flip(1)]),
                            -torch.exp(self.A_log), torch.stack([B, B.flip(1)]), torch.stack([C, C.flip(1)]),
                            self.D)
        y = y[0] + y[1].flip(1)
        return x + self.out_proj((y * F.silu(z)).to(x.dtype))


def _interp_flat_pos(pos: torch.Tensor, n_tokens_out: int, has_cls: bool = True) -> torch.Tensor:
    """Resize a flat (1, P (+1), C) position embedding to ``n_tokens_out`` tokens: the cls
    position sits in the middle (token P // 2); it is taken out, the patch grid is resized
    linearly (antialiased where it shrinks) and the cls position goes back to the new middle."""
    n_in = pos.shape[1] - int(has_cls)
    n_out = n_tokens_out - int(has_cls)
    g_in, g_out = int(round(n_in ** 0.5)), int(round(n_out ** 0.5))
    if has_cls:
        tp = n_in // 2
        cls_pos, grid = pos[:, tp:tp + 1], torch.cat([pos[:, :tp], pos[:, tp + 1:]], dim=1)
    else:
        cls_pos, grid = None, pos
    grid = resize_linear(grid.reshape(1, g_in, g_in, -1), (1, g_out, g_out, grid.shape[-1]))
    flat = grid.reshape(1, g_out * g_out, -1).to(pos.dtype)
    if not has_cls:
        return flat
    tp_out = n_out // 2
    return torch.cat([flat[:, :tp_out], cls_pos, flat[:, tp_out:]], dim=1)


class ViM(nn.Module):
    """Vision Mamba encoder: x (N, C, H, W) -> (features (N, embed_dim, H / p, W / p),
    [the same after each of ``feature_indexes``]), float32."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, in_chans: int = 3, embed_dim: int = 192,
                 depth: int = 24, state_dim: int = 16, feature_indexes: Sequence[int] = (5, 11, 17, 23),
                 variant: str = "hustvl", with_cls_token: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant not in ("hustvl", "native"):
            raise ValueError(f"Unknown ViM variant {variant!r}")
        self.img_size, self.patch_size, self.embed_dim = img_size, patch_size, embed_dim
        self.feature_indexes = tuple(feature_indexes)
        self.variant = variant
        self.with_cls_token = with_cls_token and variant == "hustvl"
        self.dtype = dtype
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        if variant == "hustvl":
            if self.with_cls_token:
                self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
            self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + int(self.with_cls_token), embed_dim))
            self.layers = nn.ModuleList([BiMambaMixerV2(embed_dim, state_dim) for _ in range(depth)])
            self.norm_f = RMSNorm(embed_dim)
        else:
            self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
            self.layers = nn.ModuleList([MambaBlock(embed_dim, state_dim) for _ in range(depth)])
            self.norm_f = LayerNorm(embed_dim)

    def reset_parameters_from(self, generator: torch.Generator):
        """flax's initialisers, as the JAX package's module: lecun-normal kernels (the depthwise
        convs' fan-in is their width), zero biases, cls token and step-size bias, unit norms and
        D, A = -[1, ..., N], a normal(0.02) position embedding."""
        for m in self.modules():
            if isinstance(m, (Linear, Conv2d)):
                m.reset_parameters_from(generator)
            elif isinstance(m, _CausalConv1d):
                lecun_normal_(m.weight, generator, fan_in=m.kernel_size[0])
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, (RMSNorm, nn.LayerNorm)):
                nn.init.ones_(m.weight)
                if getattr(m, "bias", None) is not None:
                    nn.init.zeros_(m.bias)
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf in ("A_log", "A_b_log"):
                    p.copy_(_a_log(p.shape[0], p.shape[1]))
                elif leaf in ("D", "D_b"):
                    p.fill_(1.0)
                elif leaf in ("dt_bias", "cls_token"):
                    p.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        h = self.patch_embed(x.to(self.dtype))
        b, gh, gw, c = h.shape
        if self.variant == "native":
            pos_embed = self.pos_embed
            if (gh, gw) != tuple(pos_embed.shape[1:3]):
                pos_embed = resize_linear(pos_embed, (1, gh, gw, c))
            h = (h + pos_embed.to(h.dtype)).reshape(b, gh * gw, c)
            intermediates = []
            for i, layer in enumerate(self.layers):
                h = layer(h)
                if i in self.feature_indexes:
                    intermediates.append(at_least_f32(h.reshape(b, gh, gw, c).permute(0, 3, 1, 2)))
            h = self.norm_f(h)
            return at_least_f32(h.reshape(b, gh, gw, c).permute(0, 3, 1, 2)), intermediates

        n_patch = gh * gw
        h = h.reshape(b, n_patch, c)
        if self.with_cls_token:
            tp = n_patch // 2  # the cls token in the middle of the sequence
            h = torch.cat([h[:, :tp], self.cls_token.to(h.dtype).expand(b, 1, c), h[:, tp:]], dim=1)
        pos_embed = self.pos_embed
        if h.shape[1] != pos_embed.shape[1]:
            pos_embed = _interp_flat_pos(pos_embed, h.shape[1], has_cls=self.with_cls_token)
        h = h + pos_embed.to(h.dtype)

        def feature_map(seq):
            # the reference drops token 0, not the middle cls token
            seq = seq[:, 1:] if self.with_cls_token else seq
            return at_least_f32(seq.reshape(b, gh, gw, c).permute(0, 3, 1, 2))

        intermediates = []
        hidden, residual = h, None
        for i, layer in enumerate(self.layers):
            hidden, residual = layer(hidden, residual)
            if i in self.feature_indexes:
                intermediates.append(feature_map(hidden))
        hidden = self.norm_f(residual + at_least_f32(hidden)).to(h.dtype)  # the final fused add-norm
        return feature_map(hidden), intermediates


VIM_CONFIGS = {
    "vim_t": dict(embed_dim=192, depth=24, feature_indexes=(5, 11, 17, 23)),
    "vim_s": dict(embed_dim=384, depth=24, feature_indexes=(5, 11, 17, 23)),
    "vim_b": dict(embed_dim=768, depth=24, feature_indexes=(5, 11, 17, 23)),
}


def get_vim_encoder(model_type: str = "vim_t", with_cls_token: bool = True, img_size: int = 1024,
                    in_chans: int = 3, dtype: torch.dtype = torch.float32, **kwargs) -> ViM:
    """A ViM encoder of ``VIM_CONFIGS[model_type]`` (``kwargs`` override it); its parameters are
    uninitialised until ``reset_parameters_from`` or ``load_vim_weights``."""
    if model_type not in VIM_CONFIGS:
        raise ValueError(f"Unknown vim model {model_type}; available: {sorted(VIM_CONFIGS)}")
    cfg = dict(VIM_CONFIGS[model_type])
    cfg.update(kwargs)
    return ViM(img_size=img_size, in_chans=in_chans, with_cls_token=with_cls_token, dtype=dtype, **cfg)


def get_vimunet_model(
    out_channels: int = 1,
    model_type: str = "vim_t",
    img_size: int = 1024,
    with_cls_token: bool = True,
    checkpoint: Optional[str] = None,
    in_chans: int = 3,
    final_activation: Optional[str] = "Sigmoid",
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    **kwargs,
):
    """A ViM-UNet: the ViM encoder in the UNETR decoder with ``use_skip_connection=False`` and
    ``resize_input=False``, initialised from ``seed``; ``checkpoint`` then loads a hustvl/Vim
    ``.pth`` into the encoder. As in the JAX
    package, ``variant`` and ``state_dim`` go to the encoder, ``initial_features`` and
    ``depth`` to the decoder."""
    from .unetr import UNETRModule, _init_decoder, _place

    init_kwargs = dict(out_channels=out_channels, model_type=model_type, img_size=img_size,
                       with_cls_token=with_cls_token, checkpoint=checkpoint, in_chans=in_chans,
                       final_activation=final_activation, dtype=dtype, seed=seed, **kwargs)
    encoder = get_vim_encoder(model_type, with_cls_token, img_size, in_chans,
                              **{k: kwargs[k] for k in ("variant", "state_dim") if k in kwargs})
    model = UNETRModule(encoder, img_size=img_size, out_channels=out_channels, in_chans=in_chans, resize_input=False,
                        use_skip_connection=False, final_activation=final_activation, dtype=dtype,
                        **{k: kwargs[k] for k in ("initial_features", "depth") if k in kwargs})
    generator = torch.Generator().manual_seed(seed)
    encoder.reset_parameters_from(generator)
    _init_decoder(model, generator)
    if checkpoint is not None:
        load_vim_weights(model, checkpoint)
    return _place(model, get_vimunet_model, init_kwargs, device)


def load_vim_weights(model: nn.Module, checkpoint: Union[str, Dict[str, torch.Tensor]], strict: bool = True):
    """Load a hustvl/Vim checkpoint (a ``.pth`` path or a state dict, the ``model`` entry of one
    included; its classification ``head`` is dropped) into a ``ViM`` or a ViM-UNet's encoder in
    place, by name, its position embedding resized to the model's token count. With
    ``strict`` a tensor without a counterpart of its shape raises. Returns the model."""
    state = torch.load(checkpoint, map_location="cpu", weights_only=False) if isinstance(checkpoint, str) else checkpoint
    if "model" in state and isinstance(state["model"], dict):
        state = state["model"]
    state = {k: v for k, v in state.items() if not k.startswith("head.")}
    encoder = model if isinstance(model, ViM) else model.encoder
    own = encoder.state_dict()
    if "pos_embed" in state and tuple(state["pos_embed"].shape) != tuple(own["pos_embed"].shape):
        state["pos_embed"] = _interp_flat_pos(state["pos_embed"].float(), own["pos_embed"].shape[1],
                                              has_cls=encoder.with_cls_token)
    load_by_name(encoder, state, "load_vim_weights", strict)
    return model
