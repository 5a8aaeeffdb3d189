"""The port's DINOv2 and DINOv3 encoders and ``resize_cubic`` against the JAX package's, on the CPU in float32.

The same seeded numpy inputs and the JAX module's weights (random LayerScales
and tokens in place of their init's constants), carried over with
``dino_state_dict_from_jax_params``, go through both sides. Small encoders:
embed 32, 9 blocks (three intermediate grids), 2 heads, patch 8 on a 32x32 model (a 4x4 grid);
DINOv2 also at 48x48 and 24x24 inputs, where the position embedding grows
and shrinks through the cubic resize, DINOv3 at a rectangular 32x48.

``load_dino_weights`` is held against the JAX loader on checkpoints built
here in the native layout and in the transformers (HF) layout (random
tensors under the keys and shapes the JAX loader takes), saved with
``torch.save``; ``strict`` refuses an unmatched tensor on both sides.

Tolerances: forwards within 1e-4 of the largest magnitude (float32 sums in
another order); gradients within 1e-3 of each tensor's L2 norm;
``resize_cubic`` within 1e-5 of the largest value (two float32 matrix
products against JAX's one contraction).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from torch_em_tpu.models import dino as jdino
from torch_em_tpu.models.unetr import UNETRModule as JaxUNETRModule
from torch_em_tpu.models.vit import load_sam_weights as jax_load_sam_weights
from torch_em_tpu_torch.models import DinoV2ViT, DinoV3ViT, get_vision_transformer, load_sam_weights
from torch_em_tpu_torch.models.base import resize_cubic
from torch_em_tpu_torch.models.unetr import UNETRModule
from torch_em_tpu_torch.utils.convert import dino_state_dict_from_jax_params, unetr_state_dict_from_jax_params

RTOL = 1e-4
V2 = dict(img_size=32, patch_size=8, embed_dim=32, depth=9, num_heads=2)
V3 = dict(img_size=32, patch_size=8, embed_dim=32, depth=9, num_heads=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Six test workers' thread pools oversubscribe the CPU; one thread per worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_close(got, expected, rtol=RTOL):
    expected = np.asarray(expected)
    assert got.shape == expected.shape
    np.testing.assert_allclose(np.asarray(got), expected, rtol=0, atol=rtol * np.abs(expected).max())


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def _randomized(flat, seed=1):
    """Random LayerScales (ones at init) and biases (zeros at init)."""
    rng = np.random.default_rng(seed)
    return {k: (v + rng.normal(size=v.shape).astype(np.float32) * 0.1
                if k.endswith(("gamma", "bias")) else v) for k, v in flat.items()}


def _input(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(jax_cls, port_cls, kwargs):
    return _cached_pair(jax_cls, port_cls, tuple(sorted(kwargs.items())))


@functools.lru_cache(maxsize=None)
def _cached_pair(jax_cls, port_cls, items, seed=0):
    """Both sides with the same weights, built once per configuration."""
    kwargs = dict(items)
    module = jax_cls(**kwargs)
    size = kwargs["img_size"]
    flat = _randomized(_flat(jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 3, size, size)))["params"]))
    port = port_cls(**kwargs)
    port.load_state_dict(dino_state_dict_from_jax_params(flat), strict=True)
    return module, {"params": _tree(flat)}, port.eval()


def _check_forward(module, variables, port, x):
    out, feats = jax.jit(module.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got, got_feats = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and len(got_feats) == len(feats) == 3
    _assert_close(got.numpy(), out)
    for g, e in zip(got_feats, feats):
        _assert_close(g.numpy(), e)


@pytest.mark.parametrize("shape,out", [((1, 7, 9, 5), (1, 14, 20, 5)), ((1, 7, 9, 5), (1, 3, 4, 5)),
                                       ((1, 37, 37, 8), (1, 16, 16, 8)), ((2, 6, 4), (2, 13, 3))],
                         ids=["up", "down", "dinov2-grid-down", "mixed"])
def test_resize_cubic_matches_jax(shape, out):
    x = _input(shape, 3)
    expected = np.asarray(jax.image.resize(jnp.asarray(x), out, "cubic"))
    _assert_close(resize_cubic(torch.from_numpy(x), out).numpy(), expected, 1e-5)


@pytest.mark.parametrize("variant", [dict(num_register_tokens=2), dict(), dict(ffn="swiglu_fused")],
                         ids=["registers", "no-registers", "swiglu-fused"])
@pytest.mark.parametrize("size", [32, 48, 24], ids=["img_size", "grown-grid", "shrunk-grid"])
def test_dinov2_matches_jax(variant, size):
    module, variables, port = _pair(jdino.DinoV2ViT, DinoV2ViT, dict(V2, **variant))
    _check_forward(module, variables, port, _input((2, 3, size, size), size))


@pytest.mark.parametrize("variant", [dict(num_register_tokens=4), dict(ffn="swiglu", mlp_ratio=6.0)],
                         ids=["storage-tokens", "gated-swiglu"])
@pytest.mark.parametrize("hw", [(32, 32), (32, 48)], ids=["square", "rectangular"])
def test_dinov3_matches_jax(variant, hw):
    module, variables, port = _pair(jdino.DinoV3ViT, DinoV3ViT, dict(V3, **variant))
    _check_forward(module, variables, port, _input((2, 3) + hw, 5))


@pytest.mark.parametrize("family", ["dinov2", "dinov3"])
def test_dino_gradients_match_jax(family):
    jax_cls, port_cls, kwargs = ((jdino.DinoV2ViT, DinoV2ViT, dict(V2, num_register_tokens=2)) if family == "dinov2"
                                 else (jdino.DinoV3ViT, DinoV3ViT, dict(V3, num_register_tokens=4)))
    module, variables, port = _pair(jax_cls, port_cls, kwargs)
    rng = np.random.default_rng(7)
    x = _input((2, 3, 40, 40), 8)
    w_out, w_feat = (rng.normal(size=(2, 32, 5, 5)).astype(np.float32) for _ in range(2))

    def loss_fn(params):
        out, feats = module.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(out * w_out) + jnp.sum(feats[0] * w_feat)

    grads = dino_state_dict_from_jax_params(_flat(jax.jit(jax.grad(loss_fn))(variables["params"])))
    port.zero_grad()
    out, feats = port(torch.from_numpy(x))
    ((out * torch.from_numpy(w_out)).sum() + (feats[0] * torch.from_numpy(w_feat)).sum()).backward()
    for name, p in port.named_parameters():
        expected = grads[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - expected)
        assert err <= 1e-3 * np.linalg.norm(expected) + 1e-7, (name, err, np.linalg.norm(expected))


def _hf_dinov2(state):
    """Native DINOv2 names to transformers' Dinov2Model names, qkv split per projection."""
    out = {}
    for k, v in state.items():
        if k.endswith("attn.qkv.weight") or k.endswith("attn.qkv.bias"):
            i, kind = k.split(".")[1], k.rsplit(".", 1)[1]
            for name, part in zip(("query", "key", "value"), v.chunk(3, dim=0)):
                out[f"encoder.layer.{i}.attention.attention.{name}.{kind}"] = part
            continue
        k = k.replace("patch_embed.proj", "embeddings.patch_embeddings.projection")
        k = k.replace("pos_embed", "embeddings.position_embeddings")
        for token in ("cls_token", "register_tokens"):
            k = k.replace(token, f"embeddings.{token}") if k == token else k
        k = k.replace("attn.proj", "attention.output.dense")
        k = k.replace("ls1.gamma", "layer_scale1.lambda1").replace("ls2.gamma", "layer_scale2.lambda1")
        k = k.replace("mlp.w12", "mlp.weights_in").replace("mlp.w3", "mlp.weights_out")
        k = "layernorm." + k[len("norm."):] if k.startswith("norm.") else k
        k = "encoder.layer." + k[len("blocks."):] if k.startswith("blocks.") else k
        out[k] = v
    return out


def _hf_dinov3(state):
    """Native DINOv3 names to transformers' DINOv3ViTModel names."""
    out = {}
    for k, v in state.items():
        k = k.replace("patch_embed.proj", "embeddings.patch_embeddings")
        for token in ("cls_token", "register_tokens"):
            k = f"embeddings.{token}" if k == token else k
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            k = k.replace(f"attn.{proj}", f"attention.{proj}")
        k = k.replace("ls1.gamma", "layer_scale1.lambda1").replace("ls2.gamma", "layer_scale2.lambda1")
        k = k.replace("mlp.fc1", "mlp.up_proj").replace("mlp.fc2", "mlp.down_proj").replace("mlp.gate", "mlp.gate_proj")
        k = "layer." + k[len("blocks."):] if k.startswith("blocks.") else k
        out[k] = v
    return out


@pytest.mark.parametrize("family,layout", [("dinov2", "native"), ("dinov2", "hf"), ("dinov3", "native"),
                                           ("dinov3", "hf")])
def test_load_dino_weights_matches_jax(family, layout, tmp_path):
    """A checkpoint built here (random tensors under the loader's keys, with a mask token and,
    for DINOv3, the unused key bias) loads into both sides to the same function."""
    jax_cls, port_cls, kwargs = ((jdino.DinoV2ViT, DinoV2ViT, dict(V2, num_register_tokens=2, ffn="swiglu_fused"))
                                 if family == "dinov2" else
                                 (jdino.DinoV3ViT, DinoV3ViT, dict(V3, num_register_tokens=4, ffn="swiglu",
                                                                   mlp_ratio=6.0)))
    module, variables, _ = _pair(jax_cls, port_cls, kwargs)
    rng = np.random.default_rng(9)
    port = port_cls(**kwargs)
    state = {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32) * 0.2)
             for k, v in port.state_dict().items()}
    state["mask_token"] = torch.zeros(1, 32)
    if family == "dinov3":
        state["blocks.0.attn.k_proj.bias"] = torch.zeros(32)
    if layout == "hf":
        state = (_hf_dinov2 if family == "dinov2" else _hf_dinov3)(state)
    path = str(tmp_path / "dino.pth")
    torch.save(state, path)

    loaded = jdino.load_dino_weights(jax.device_get(variables), path, backbone=family)
    assert load_sam_weights(port, path, backbone=family) is port
    _check_forward(module, loaded, port.eval(), _input((1, 3, 32, 32), 10))
    via_vit = jax_load_sam_weights(jax.device_get(variables), path, backbone=family)
    np.testing.assert_array_equal(np.asarray(via_vit["params"]["cls_token"]), np.asarray(loaded["params"]["cls_token"]))

    state["blocks.0.attn.extra.weight"] = torch.zeros(3, 3)
    torch.save(state, path)
    with pytest.raises(KeyError):
        jdino.load_dino_weights(jax.device_get(variables), path, backbone=family)
    with pytest.raises(ValueError, match="unmatched"):
        load_sam_weights(port, path, backbone=family)
    with pytest.warns(UserWarning, match="unmatched"):
        load_sam_weights(port, path, backbone=family, strict=False)


@pytest.mark.parametrize("family", ["dinov2", "dinov3"])
def test_unetr_with_dino_encoder_matches_jax(family):
    """UNETR end to end with a DINO encoder (skip connections from its three intermediate
    grids, ImageNet statistics), 48x48 one-channel inputs resized to 32 and back."""
    jax_cls, port_cls, kwargs = ((jdino.DinoV2ViT, DinoV2ViT, dict(V2, num_register_tokens=2)) if family == "dinov2"
                                 else (jdino.DinoV3ViT, DinoV3ViT, dict(V3, num_register_tokens=4)))
    decoder = dict(img_size=32, out_channels=2, use_dino_stats=True, final_activation="Sigmoid", initial_features=8)
    jax_module = JaxUNETRModule(**decoder, encoder_module=jax_cls(**kwargs))
    variables = jax.jit(jax_module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))
    rng = np.random.default_rng(1)
    stats = {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("var") else rng.normal(size=v.shape) * 0.1)
             .astype(np.float32) for k, v in _flat(variables["batch_stats"]).items()}
    params = _flat(variables["params"])
    model = UNETRModule(port_cls(**kwargs), **decoder).eval()
    model.load_state_dict(unetr_state_dict_from_jax_params(params, stats), strict=True)
    x = _input((2, 1, 48, 48), 11)
    expected = jax.jit(jax_module.apply)({"params": _tree(params), "batch_stats": _tree(stats)}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _assert_close(got.numpy(), expected)


@pytest.mark.parametrize("backbone,model,cls", [("dinov2", "vit_b_reg4", DinoV2ViT), ("dinov3", "vit_s+", DinoV3ViT)])
def test_get_vision_transformer_builds_dino(backbone, model, cls):
    encoder = get_vision_transformer(backbone, model, img_size=64, depth=1)
    assert type(encoder) is cls and encoder.num_register_tokens == 4
    with pytest.raises(ValueError, match="is not supported by"):
        get_vision_transformer(backbone, "vit_x")
