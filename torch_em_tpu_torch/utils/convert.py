"""Carry the JAX package's flax weights into the port's models.

U-Nets (``state_dict_from_jax_params``):

The port keeps its own copy of the mapping in
``torch_em_tpu/utils/modelzoo.py:torch_state_dict_from_flax``: flax block
``encoder<i>`` / ``base`` / ``decoder<i>`` with convs ``conv0`` and ``conv1``
becomes torch-em's ``encoder.blocks.<i>.block.{1,4}`` (``{0,2}`` without a
norm), ``sampler<i>/conv`` becomes ``decoder.samplers.<i>.conv``, and
``out_conv`` stays (``out_conv<i>`` of a model with side outputs becomes
``out_conv.<i>``). Conv kernels go from (*kernel, I, O) to (O, I, *kernel);
the upsamplers' and the output's 1x1 convs are flax ``Dense`` layers with an
(I, O) kernel and become (O, I, 1, ..., 1). A block's norms ``norm0`` and
``norm1`` sit at ``block.{0,3}``: the ``scale`` and ``bias`` of their flax
child (``GroupNorm_0``, ``BatchNorm_0``, ``_InstanceNormTrackStats_0``)
become ``weight`` and ``bias``, and the ``mean`` and ``var`` of the
``batch_stats`` collection ``running_mean`` and ``running_var``.

The Probabilistic U-Net (``probabilistic_unet_state_dict_from_jax_params``):
its ``unet`` subtree takes the U-Net rules under ``unet.``; the prior's and
the posterior's ``conv<level>_<i>`` go to torch-em's positions in
``<encoder>.encoder.layers`` (a pool before each level past the first, then
conv/ReLU pairs), ``mu_log_sigma`` to ``<encoder>.conv_layer``, and
``fcomb<i>`` and ``last_layer`` to ``fcomb.layers.<2i>`` and
``fcomb.last_layer``. Their kernels are flax ``Conv``s, channels-last HWIO,
and become OIHW.

Transformer models (``vit_state_dict_from_jax_params``,
``vim_state_dict_from_jax_params``, ``dino_state_dict_from_jax_params``,
``mae_state_dict_from_jax_params``, ``scalemae_state_dict_from_jax_params``,
``hiera_state_dict_from_jax_params``, ``sam3_state_dict_from_jax_params``,
``unetr_state_dict_from_jax_params``, ``unetr3d_state_dict_from_jax_params``):
the port's names are segment-anything's for the ViT, hustvl/Vim's for the
ViM, the native checkpoints' for DINO, timm's for (Scale)MAE, sam2's for
Hiera, vitdet's for SAM3 and torch-em's for the UNETR decoder (the port's
copy of the JAX package's ``utils/modelzoo.py:_torch_state_dict_unetr``).
Dense kernels (I, O) become (O, I), except the upsamplers', which become 1x1
conv weights; the Mamba layers' depthwise conv kernels (K, 1, E) become (E,
1, K); Hiera's position tables (1, h, w, C) become (1, C, h, w); flax's
``scale`` becomes ``weight``. The UNETR converters tell the encoder's family
by its parameters.

3-D ResNets (``resnet3d_state_dict_from_jax_params``): ``layer<s>_<b>``
becomes torchvision's ``layer<s>.<b>``, ``downsample_conv``/``downsample_bn``
its ``downsample.0``/``.1``, the ``batch_stats`` the norms' running
statistics.
"""

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "state_dict_from_jax_params", "vit_state_dict_from_jax_params", "vim_state_dict_from_jax_params",
    "unetr_state_dict_from_jax_params", "unetr3d_state_dict_from_jax_params",
    "probabilistic_unet_state_dict_from_jax_params", "dino_state_dict_from_jax_params",
    "mae_state_dict_from_jax_params", "scalemae_state_dict_from_jax_params", "hiera_state_dict_from_jax_params",
    "sam3_state_dict_from_jax_params", "resnet3d_state_dict_from_jax_params",
]


def _conv_weight(kernel: np.ndarray, spatial_rank: int) -> np.ndarray:
    kernel = np.asarray(kernel, dtype=np.float32)
    if kernel.ndim == 2:  # dense 1x1: (I, O) -> (O, I, 1, ..., 1)
        return kernel.T.reshape(kernel.shape[::-1] + (1,) * spatial_rank)
    if kernel.ndim != spatial_rank + 2:
        raise ValueError(f"kernel of rank {kernel.ndim} in a {spatial_rank}D model")
    rank = kernel.ndim
    return kernel.transpose((rank - 1, rank - 2) + tuple(range(rank - 2)))


def state_dict_from_jax_params(
    flat: Dict[str, np.ndarray], norm: Optional[str] = "InstanceNorm",
    batch_stats: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, torch.Tensor]:
    """Map a flax U-Net's ``params`` tree, flattened to ``/``-joined keys, onto the port's state dict.

    ``norm`` is the model's norm: it decides whether the convs of a block
    sit at ``block.{1,4}`` (behind norms) or ``block.{0,2}`` (no norm), and
    which norm parameters there are. ``batch_stats`` is the flattened
    ``batch_stats`` collection of a model with ``"BatchNorm"`` or
    ``"InstanceNormTrackStats"``.
    """
    if norm not in (None, "InstanceNorm", "InstanceNormTrackStats", "GroupNorm", "BatchNorm"):
        raise ValueError(f"Invalid norm: {norm!r}")
    tracked = norm in ("BatchNorm", "InstanceNormTrackStats")
    if tracked and not batch_stats:
        raise ValueError(f"norm={norm!r} needs the model's batch_stats")
    conv_idx = (0, 2) if norm is None else (1, 4)
    spatial_rank = max(np.ndim(v) for v in flat.values()) - 2

    def grouped(tree):
        groups = {}
        for key, value in (tree or {}).items():
            top, rest = key.split("/", 1)
            groups.setdefault(top, {})[rest] = value
        return groups

    groups, stats = grouped(flat), grouped(batch_stats)
    state = {}

    def leaf(tree, j, name):
        """The ``name`` leaf of the j-th norm's flax child in a block's flattened tree."""
        found = [v for k, v in tree.items() if k.startswith(f"norm{j}/") and k.endswith(f"/{name}")]
        if len(found) != 1:
            raise ValueError(f"expected one norm{j}/*/{name}, found {len(found)}")
        return found[0]

    def block(src, dst):
        params = groups.pop(src)
        for j in range(2):
            state[f"{dst}.block.{conv_idx[j]}.weight"] = _conv_weight(
                params[f"conv{j}/kernel"], spatial_rank)
            state[f"{dst}.block.{conv_idx[j]}.bias"] = params[f"conv{j}/bias"]
            if norm not in (None, "InstanceNorm"):
                state[f"{dst}.block.{3 * j}.weight"] = leaf(params, j, "scale")
                state[f"{dst}.block.{3 * j}.bias"] = leaf(params, j, "bias")
            if tracked:
                state[f"{dst}.block.{3 * j}.running_mean"] = leaf(stats[src], j, "mean")
                state[f"{dst}.block.{3 * j}.running_var"] = leaf(stats[src], j, "var")

    n_levels = len([k for k in groups if k.startswith("encoder")])
    for i in range(n_levels):
        block(f"encoder{i}", f"encoder.blocks.{i}")
        block(f"decoder{i}", f"decoder.blocks.{i}")
        sampler = groups.pop(f"sampler{i}")
        state[f"decoder.samplers.{i}.conv.weight"] = _conv_weight(
            sampler["conv/kernel"], spatial_rank)
        state[f"decoder.samplers.{i}.conv.bias"] = sampler["conv/bias"]
        if f"out_conv{i}" in groups:  # side outputs
            out = groups.pop(f"out_conv{i}")
            state[f"out_conv.{i}.weight"] = _conv_weight(out["kernel"], spatial_rank)
            state[f"out_conv.{i}.bias"] = out["bias"]
    block("base", "base")
    if "out_conv" in groups:
        out = groups.pop("out_conv")
        state["out_conv.weight"] = _conv_weight(out["kernel"], spatial_rank)
        state["out_conv.bias"] = out["bias"]
    if groups:
        raise ValueError(f"Unmapped parameter groups: {sorted(groups)}")
    result = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()}
    if tracked:  # torch's counter, which the JAX package does not keep
        for key in [k for k in result if k.endswith(".running_mean")]:
            result[key.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(0, dtype=torch.long)
    return result


_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
# (module path pattern, port module path, kind of its kernel): "linear" (I, O) -> (O, I), "conv"
# (flax conv or dense 1x1) -> torch conv weight, "depthwise" (K, 1, E) -> (E, 1, K); other
# leaves (biases, scales, statistics) and the bare tensors (``_*_TENSORS``) keep their layout
_Rules = List[Tuple[str, str, str]]

_VIT_RULES: _Rules = [
    (r"patch_embed", "patch_embed.proj", "conv"),
    (r"block(\d+)/norm([12])", r"blocks.\1.norm\2", "linear"),
    (r"block(\d+)/attn/(qkv|proj)", r"blocks.\1.attn.\2", "linear"),
    (r"block(\d+)/mlp_lin([12])", r"blocks.\1.mlp.lin\2", "linear"),
    (r"neck_conv1", "neck.0", "conv"), (r"neck_ln1", "neck.1", "linear"),
    (r"neck_conv2", "neck.2", "conv"), (r"neck_ln2", "neck.3", "linear"),
]
_VIT_TENSORS = [(r"pos_embed", "pos_embed"), (r"block(\d+)/attn/(rel_pos_[hw])", r"blocks.\1.attn.\2")]

_VIM_RULES: _Rules = [
    (r"patch_embed", "patch_embed.proj", "conv"),
    (r"norm_f", "norm_f", "linear"),
    # variant "hustvl": hustvl/Vim's Block(norm, mixer)
    (r"block(\d+)/norm", r"layers.\1.norm", "linear"),
    (r"block(\d+)/(in_proj|out_proj|x_proj|x_proj_b|dt_proj|dt_proj_b)", r"layers.\1.mixer.\2", "linear"),
]
_VIM_TENSORS = [
    (r"pos_embed", "pos_embed"), (r"cls_token", "cls_token"),
    (r"block(\d+)/(A_log|D|D_b)", r"layers.\1.mixer.\2"), (r"block(\d+)/A_log_b", r"layers.\1.mixer.A_b_log"),
    (r"block(\d+)/conv1d(_b)?_bias", r"layers.\1.mixer.conv1d\2.bias"),
]
_VIM_DEPTHWISE = [(r"block(\d+)/conv1d(_b)?_kernel", r"layers.\1.mixer.conv1d\2.weight")]
# variant "native": the JAX package's MambaBlock, one set of direction parameters
_VIM_NATIVE_RULES: _Rules = [
    (r"patch_embed", "patch_embed.proj", "conv"),
    (r"norm_f", "norm_f", "linear"),
    (r"block(\d+)/(norm|in_proj|out_proj|x_proj)", r"layers.\1.\2", "linear"),
]
_VIM_NATIVE_TENSORS = [(r"pos_embed", "pos_embed"), (r"block(\d+)/(A_log|D|dt_bias)", r"layers.\1.\2")]
_VIM_NATIVE_DEPTHWISE = [(r"block(\d+)/conv_kernel", r"layers.\1.conv1d.weight")]


# DINOv2/v3, MAE and ScaleMAE (dino._DinoBlock): the native and timm names
_TOKEN_VIT_RULES: _Rules = [
    (r"patch_embed", "patch_embed.proj", "conv"), (r"norm", "norm", "linear"),
    (r"block(\d+)/(norm[12])", r"blocks.\1.\2", "linear"),
    (r"block(\d+)/attn/(qkv|proj|q_proj|k_proj|v_proj|o_proj)", r"blocks.\1.attn.\2", "linear"),
    (r"block(\d+)/mlp_(fc1|fc2|w12|w3|gate)", r"blocks.\1.mlp.\2", "linear"),
    (r"block(\d+)/mlp_up", r"blocks.\1.mlp.fc1", "linear"), (r"block(\d+)/mlp_down", r"blocks.\1.mlp.fc2", "linear"),
]
_TOKEN_VIT_TENSORS = [(r"(cls_token|pos_embed|register_tokens)", r"\1"),
                      (r"block(\d+)/(ls[12])/gamma", r"blocks.\1.\2.gamma")]
# sam2's Hiera and FPN neck
_HIERA_RULES: _Rules = [
    (r"patch_embed", "trunk.patch_embed.proj", "conv"),
    (r"block(\d+)/(norm[12]|proj)", r"trunk.blocks.\1.\2", "linear"),
    (r"block(\d+)/attn/(qkv|proj)", r"trunk.blocks.\1.attn.\2", "linear"),
    (r"block(\d+)/mlp_lin1", r"trunk.blocks.\1.mlp.layers.0", "linear"),
    (r"block(\d+)/mlp_lin2", r"trunk.blocks.\1.mlp.layers.1", "linear"),
    (r"neck_conv(\d+)", r"neck.convs.\1.conv", "conv"),
]
_HIERA_NCHW = [(r"(pos_embed|pos_embed_window)", r"trunk.\1")]
# SAM3's vitdet
_SAM3_RULES: _Rules = [
    (r"patch_embed", "patch_embed.proj", "conv"), (r"ln_pre", "ln_pre", "linear"),
    (r"block(\d+)/(norm[12])", r"blocks.\1.\2", "linear"),
    (r"block(\d+)/attn/(qkv|proj)", r"blocks.\1.attn.\2", "linear"),
    (r"block(\d+)/mlp_lin([12])", r"blocks.\1.mlp.fc\2", "linear"),
]
_SAM3_TENSORS = [(r"pos_embed", "pos_embed")]
# the 3-D ResNets, torchvision's names
_RESNET3D_RULES: _Rules = [
    (r"(conv1|bn1)", r"\1", "conv"), (r"fc", "fc", "linear"),
    (r"layer(\d+)_(\d+)/(conv\d|bn\d)", r"layer\1.\2.\3", "conv"),
    (r"layer(\d+)_(\d+)/downsample_conv", r"layer\1.\2.downsample.0", "conv"),
    (r"layer(\d+)_(\d+)/downsample_bn", r"layer\1.\2.downsample.1", "conv"),
]


def _convert(value, kind: str, spatial_rank: int) -> np.ndarray:
    value = np.asarray(value, dtype=np.float32)
    if kind == "nchw":
        return value.transpose(0, 3, 1, 2)
    if kind == "tensor" or value.ndim < 2:
        return value
    if kind == "linear":
        return value.T
    if kind == "depthwise":
        return value.transpose(2, 1, 0)
    return _conv_weight(value, spatial_rank)


def _map(flat: Dict[str, np.ndarray], rules: _Rules, tensors=(), depthwise=(), spatial_rank: int = 2,
         prefix: str = "", nchw=()) -> Dict[str, np.ndarray]:
    """Rename every entry of ``flat`` (``/``-joined flax keys) by the first rule that matches it
    whole; an entry that no rule matches raises."""
    state = {}
    for key, value in flat.items():
        module, _, leaf = key.rpartition("/")
        candidates = [(p, t, "tensor", key, "") for p, t in tensors] + \
                     [(p, t, "depthwise", key, "") for p, t in depthwise] + \
                     [(p, t, "nchw", key, "") for p, t in nchw]
        if leaf in _LEAF:
            candidates += [(p, t, kind if leaf == "kernel" else "linear", module, "." + _LEAF[leaf])
                           for p, t, kind in rules]
        for pattern, target, kind, subject, suffix in candidates:
            match = re.fullmatch(pattern, subject)
            if match:
                state[prefix + match.expand(target) + suffix] = _convert(value, kind, spatial_rank)
                break
        else:
            raise ValueError(f"Unmapped parameter: {key}")
    return state


def _tensors(state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    result = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()}
    for key in [k for k in result if k.endswith(".running_mean")]:  # torch's counter, which flax does not keep
        result[key.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(0, dtype=torch.long)
    return result


def _subtree(flat: Dict[str, np.ndarray], top: str) -> Dict[str, np.ndarray]:
    return {k[len(top) + 1:]: v for k, v in flat.items() if k.startswith(top + "/")}


def vit_state_dict_from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A flax ``ViT``'s flattened ``params`` onto the port's ``ViT`` (segment-anything's names)."""
    return _tensors(_map(flat, _VIT_RULES, _VIT_TENSORS))


def _vim_state(flat: Dict[str, np.ndarray], prefix: str = "") -> Dict[str, np.ndarray]:
    if any(re.fullmatch(r"block\d+/conv_kernel", k) for k in flat):
        return _map(flat, _VIM_NATIVE_RULES, _VIM_NATIVE_TENSORS, _VIM_NATIVE_DEPTHWISE, prefix=prefix)
    return _map(flat, _VIM_RULES, _VIM_TENSORS, _VIM_DEPTHWISE, prefix=prefix)


def vim_state_dict_from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A flax ``ViM``'s flattened ``params`` (either variant) onto the port's ``ViM``
    (hustvl/Vim's names for the ``"hustvl"`` variant)."""
    return _tensors(_vim_state(flat))


def dino_state_dict_from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A flax ``DinoV2ViT``'s, ``DinoV3ViT``'s, ``MAEViT``'s or ``ScaleMAEViT``'s flattened
    ``params`` onto the port's (the native DINO and timm names, which agree)."""
    return _tensors(_map(flat, _TOKEN_VIT_RULES, _TOKEN_VIT_TENSORS))


mae_state_dict_from_jax_params = scalemae_state_dict_from_jax_params = dino_state_dict_from_jax_params


def hiera_state_dict_from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A flax ``HieraSam2``'s flattened ``params`` onto the port's (sam2's names)."""
    return _tensors(_map(flat, _HIERA_RULES, nchw=_HIERA_NCHW))


def sam3_state_dict_from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A flax ``Sam3ViT``'s flattened ``params`` onto the port's (vitdet's names)."""
    return _tensors(_map(flat, _SAM3_RULES, _SAM3_TENSORS))


def resnet3d_state_dict_from_jax_params(
    flat: Dict[str, np.ndarray], batch_stats: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, torch.Tensor]:
    """A flax ``ResNet3dModule``'s flattened ``params`` and ``batch_stats`` onto the port's
    (torchvision's names)."""
    state = _map(flat, _RESNET3D_RULES, spatial_rank=3)
    state.update(_map(batch_stats or {}, _RESNET3D_RULES, spatial_rank=3))
    return _tensors(state)


def _encoder_state(encoder: Dict[str, np.ndarray], prefix: str = "") -> Dict[str, np.ndarray]:
    """Any encoder family's flattened ``params``, told apart by its parameters."""
    if "pos_embed_window" in encoder:
        return _map(encoder, _HIERA_RULES, nchw=_HIERA_NCHW, prefix=prefix)
    if "ln_pre/scale" in encoder:
        return _map(encoder, _SAM3_RULES, _SAM3_TENSORS, prefix=prefix)
    if not any(re.fullmatch(r"block\d+/attn/.*", k) for k in encoder):
        return _vim_state(encoder, prefix=prefix)
    if "cls_token" in encoder:
        return _map(encoder, _TOKEN_VIT_RULES, _TOKEN_VIT_TENSORS, prefix=prefix)
    return _map(encoder, _VIT_RULES, _VIT_TENSORS, prefix=prefix)


def _deconv_rules(top: str, dst: str) -> _Rules:
    """torch-em's ``Deconv2DBlock``: upsampler ``block.0.conv``, conv ``block.1.block``, norm ``block.2``."""
    return [(f"{top}/up/conv", f"{dst}.block.0.conv", "conv"), (f"{top}/conv", f"{dst}.block.1.block", "conv"),
            (f"{top}/bn", f"{dst}.block.2", "conv")]


def _conv_block_rules(top: str, dst: str) -> _Rules:
    return [(f"{top}/conv0", f"{dst}.block.1", "conv"), (f"{top}/conv1", f"{dst}.block.4", "conv")]


def unetr_state_dict_from_jax_params(
    flat: Dict[str, np.ndarray], batch_stats: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, torch.Tensor]:
    """A flax ``UNETRModule``'s flattened ``params`` and ``batch_stats`` (its deconvolutions'
    batch norms) onto the port's ``UNETRModule``: the ViT encoder (``encoder/``) or the ViM of
    a ViM-UNet (``encoder_module/``) of any family, then the decoder with torch-em's names."""
    # the JAX module keeps an encoder given to it under "encoder_module"
    top = "encoder_module" if any(k.startswith("encoder_module/") for k in flat) else "encoder"
    state = _encoder_state(_subtree(flat, top), prefix="encoder.")
    skip = any(k.startswith("deconv2_1/") for k in flat)
    rules = _deconv_rules("deconv1", "deconv1")
    if skip:
        for stage, n in ((2, 2), (3, 3)):
            for j in range(n):
                rules += _deconv_rules(f"deconv{stage}_{j}", f"deconv{stage}.{j}")
        rules += _conv_block_rules("deconv4", "deconv4")
    else:
        rules += _deconv_rules("deconv2_0", "deconv2") + _deconv_rules("deconv3_0", "deconv3")
        rules += _deconv_rules("deconv4", "deconv4")
    rules += _conv_block_rules("base_block", "base") + _conv_block_rules("decoder_head", "decoder_head")
    rules += [(r"decoder_blocks_(\d+)/conv0", r"decoder.blocks.\1.block.1", "conv"),
              (r"decoder_blocks_(\d+)/conv1", r"decoder.blocks.\1.block.4", "conv"),
              (r"decoder_samplers_(\d+)/conv", r"decoder.samplers.\1.conv", "conv"),
              ("deconv_out/conv", "deconv_out.conv", "conv"), ("out_conv", "out_conv", "conv")]
    decoder = {k: v for k, v in flat.items() if not k.startswith(("encoder/", "encoder_module/"))}
    state.update(_map(decoder, rules))
    state.update(_map(batch_stats or {}, rules))
    return _tensors(state)


def unetr3d_state_dict_from_jax_params(
    flat: Dict[str, np.ndarray], batch_stats: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, torch.Tensor]:
    """A flax ``UNETR3DModule``'s flattened ``params`` and ``batch_stats`` (the strip
    poolings' batch norms) onto the port's ``UNETR3DModule``."""
    # the JAX module names its encoder after its class: ViT_0, HieraSam2_0, DinoV2ViT_0, ...
    encoder_top = next(k.split("/")[0] for k in flat if re.match(r"(\w*ViT|HieraSam2)_\d+/", k))
    state = _encoder_state(_subtree(flat, encoder_top), prefix="encoder.")

    def with_strip(top, dst):
        return [(f"{top}/conv/conv0", f"{dst}.conv.block.1", "conv"), (f"{top}/conv/conv1", f"{dst}.conv.block.4", "conv"),
                (f"{top}/strip/conv1", f"{dst}.strip.conv1", "conv"), (f"{top}/strip/bn1", f"{dst}.strip.bn1", "conv"),
                (f"{top}/strip/conv2", f"{dst}.strip.conv2", "conv")]

    rules = []
    for top in ("deconv1", "deconv2", "deconv3", "deconv4", "deconv_out"):
        rules += [(f"{top}/up/conv", f"{top}.up.conv", "conv")] + with_strip(f"{top}/conv", f"{top}.conv")
    rules += with_strip("base", "base") + with_strip("decoder_head", "decoder_head")
    rules += with_strip(r"decoder(\d+)", r"decoders.\1")
    rules += [(r"sampler(\d+)/conv", r"samplers.\1.conv", "conv"), ("out_conv", "out_conv", "conv")]
    decoder = {k: v for k, v in flat.items() if not k.startswith(encoder_top + "/")}
    state.update(_map(decoder, rules, spatial_rank=3))
    state.update(_map(batch_stats or {}, rules, spatial_rank=3))
    return _tensors(state)


def probabilistic_unet_state_dict_from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A flax ``ProbabilisticUNetModule``'s flattened ``params`` onto the port's
    ``ProbabilisticUNetModule`` (torch-em's names for the encoders and fcomb)."""
    state = {f"unet.{k}": v for k, v in state_dict_from_jax_params(_subtree(flat, "unet")).items()}
    rest = {}
    for encoder in ("prior", "posterior"):
        tree = _subtree(flat, encoder)
        per_block = 1 + max(int(m.group(2)) for m in (re.fullmatch(r"conv(\d+)_(\d+)/kernel", k) for k in tree) if m)
        for key, value in tree.items():
            module, _, leaf = key.rpartition("/")
            match = re.fullmatch(r"conv(\d+)_(\d+)", module)
            if match:
                level, conv = int(match.group(1)), int(match.group(2))
                target = f"{encoder}.encoder.layers.{level * (2 * per_block + 1) + 2 * conv}"
            elif module == "mu_log_sigma":
                target = f"{encoder}.conv_layer"
            else:
                raise ValueError(f"Unmapped parameter: {encoder}/{key}")
            rest[f"{target}.{_LEAF[leaf]}"] = _convert(value, "conv", 2)
    for key, value in _subtree(flat, "fcomb").items():
        module, _, leaf = key.rpartition("/")
        match = re.fullmatch(r"fcomb(\d+)", module)
        if match:
            target = f"fcomb.layers.{2 * int(match.group(1))}"
        elif module == "last_layer":
            target = "fcomb.last_layer"
        else:
            raise ValueError(f"Unmapped parameter: fcomb/{key}")
        rest[f"{target}.{_LEAF[leaf]}"] = _convert(value, "conv", 2)
    unmapped = [k for k in flat if k.split("/")[0] not in ("unet", "prior", "posterior", "fcomb")]
    if unmapped:
        raise ValueError(f"Unmapped parameters: {unmapped}")
    state.update(_tensors(rest))
    return state
