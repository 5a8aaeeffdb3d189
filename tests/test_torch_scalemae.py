"""The port's MAE and ScaleMAE encoders against the JAX package's, on the CPU in float32.

The same seeded numpy inputs and the JAX module's weights (random biases in
place of their init's zeros), carried over with
``mae_state_dict_from_jax_params`` / ``scalemae_state_dict_from_jax_params``,
go through both sides. Small encoders: embed 32, 4 blocks (chunks of one),
2 heads, patch 8. MAE on a 32x32 model (a 4x4 grid) at 32, 48 and 24
pixels, where its position embedding grows and shrinks through the cubic
resize; ScaleMAE with an ``input_size`` of 32, at inputs of 32 (no resize),
24 (the cubic resize grows) and 48 (it shrinks), each with its own
resolution-scaled sincos table.

``load_mae_weights`` and ``load_scalemae_weights`` are held against the JAX
loaders on timm-layout checkpoints built here (with the decoder, mask token,
trailing norm and head that they drop), saved with ``torch.save``;
``strict`` refuses an unmatched tensor on both sides, and MAE refuses a
position table of another grid.

Tolerances: forwards within 1e-4 of the largest magnitude (float32 sums in
another order), the sincos tables within 1e-6; gradients within 1e-3 of
each tensor's L2 norm.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from torch_em_tpu.models import scalemae as jscalemae
from torch_em_tpu.models.unetr import UNETRModule as JaxUNETRModule
from torch_em_tpu_torch.models import MAEViT, ScaleMAEViT, get_vision_transformer, load_sam_weights
from torch_em_tpu_torch.models.scalemae import sincos_pos_embed_with_resolution
from torch_em_tpu_torch.models.unetr import UNETRModule
from torch_em_tpu_torch.utils.convert import (
    mae_state_dict_from_jax_params, scalemae_state_dict_from_jax_params, unetr_state_dict_from_jax_params,
)

RTOL = 1e-4
SMALL = dict(patch_size=8, embed_dim=32, depth=4, num_heads=2)
MAE = dict(SMALL, img_size=32)
SCALEMAE = dict(SMALL, input_size=32)


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


def _input(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair(family):
    """Both sides with the same weights (random biases), built once per family."""
    jax_cls, port_cls, kwargs = ((jscalemae.MAEViT, MAEViT, MAE) if family == "mae"
                                 else (jscalemae.ScaleMAEViT, ScaleMAEViT, SCALEMAE))
    module = jax_cls(**kwargs)
    rng = np.random.default_rng(1)
    flat = {k: v + (rng.normal(size=v.shape).astype(np.float32) * 0.1 if k.endswith("bias") else 0)
            for k, v in _flat(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))["params"]).items()}
    port = port_cls(**kwargs)
    port.load_state_dict(mae_state_dict_from_jax_params(flat), strict=True)
    return module, {"params": _tree(flat)}, port.eval()


def _check_forward(module, variables, port, x, n_feats):
    out, feats = jax.jit(module.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got, got_feats = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and len(got_feats) == len(feats) == n_feats
    _assert_close(got.numpy(), out)
    for g, e in zip(got_feats, feats):
        _assert_close(g.numpy(), e)


@pytest.mark.parametrize("res", [[1.25], [2.5, 0.5]], ids=["one", "per-sample"])
def test_sincos_pos_embed_matches_jax(res):
    expected = jscalemae.sincos_pos_embed_with_resolution(32, 5, jnp.asarray(res, jnp.float32))
    got = sincos_pos_embed_with_resolution(32, 5, torch.tensor(res))
    _assert_close(got.numpy(), expected, 1e-6)


@pytest.mark.parametrize("size", [32, 48, 24], ids=["img_size", "grown-grid", "shrunk-grid"])
def test_mae_matches_jax(size):
    _check_forward(*_pair("mae"), _input((2, 3, size, size), size), 3)


@pytest.mark.parametrize("size", [32, 24, 48], ids=["input_size", "resized-up", "resized-down"])
def test_scalemae_matches_jax(size):
    _check_forward(*_pair("scalemae"), _input((2, 3, size, size), size), 4)


@pytest.mark.parametrize("family", ["mae", "scalemae"])
def test_gradients_match_jax(family):
    module, variables, port = _pair(family)
    rng = np.random.default_rng(7)
    x = _input((2, 3, 40, 40), 8)
    w_out, w_feat = (rng.normal(size=(2, 32, 5 if family == "mae" else 4, 5 if family == "mae" else 4))
                     .astype(np.float32) for _ in range(2))

    def loss_fn(params):
        out, feats = module.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(out * w_out) + jnp.sum(feats[0] * w_feat)

    grads = scalemae_state_dict_from_jax_params(_flat(jax.jit(jax.grad(loss_fn))(variables["params"])))
    port.zero_grad()
    out, feats = port(torch.from_numpy(x))
    ((out * torch.from_numpy(w_out)).sum() + (feats[0] * torch.from_numpy(w_feat)).sum()).backward()
    for name, p in port.named_parameters():
        expected = grads[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - expected)
        assert err <= 1e-3 * np.linalg.norm(expected) + 1e-7, (name, err, np.linalg.norm(expected))


def _checkpoint(port, pos_grid=4, seed=9):
    """A timm-layout checkpoint of random tensors: the encoder's, a learned position table,
    and the decoder, mask token, trailing norm and head that the loaders drop."""
    rng = np.random.default_rng(seed)
    state = {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32) * 0.2)
             for k, v in port.state_dict().items()}
    state["pos_embed"] = torch.from_numpy(rng.normal(size=(1, pos_grid ** 2 + 1, 32)).astype(np.float32) * 0.2)
    state.update({"mask_token": torch.zeros(1, 1, 32), "norm.weight": torch.ones(32), "norm.bias": torch.zeros(32),
                  "decoder_embed.weight": torch.zeros(16, 32), "head.weight": torch.zeros(10, 32)})
    return state


@pytest.mark.parametrize("family", ["mae", "scalemae"])
def test_load_weights_matches_jax(family, tmp_path):
    module, variables, _ = _pair(family)
    port = (MAEViT(**MAE) if family == "mae" else ScaleMAEViT(**SCALEMAE)).eval()
    state = _checkpoint(port)
    path = str(tmp_path / f"{family}.pth")
    torch.save({"model": state}, path)
    jax_load = jscalemae.load_mae_weights if family == "mae" else jscalemae.load_scalemae_weights

    loaded = jax_load(jax.device_get(variables), path)
    assert load_sam_weights(port, path, backbone=family) is port
    _check_forward(module, loaded, port, _input((1, 3, 32, 32), 10), 3 if family == "mae" else 4)

    state["blocks.0.attn.extra.weight"] = torch.zeros(3, 3)
    torch.save({"model": state}, path)
    with pytest.raises(KeyError):
        jax_load(jax.device_get(variables), path)
    with pytest.raises(ValueError, match="unmatched"):
        load_sam_weights(port, path, backbone=family)
    with pytest.warns(UserWarning, match="unmatched"):
        load_sam_weights(port, path, backbone=family, strict=False)


def test_load_mae_weights_refuses_another_grid(tmp_path):
    module, variables, _ = _pair("mae")
    port = MAEViT(**MAE)
    path = str(tmp_path / "mae.pth")
    torch.save(_checkpoint(port, pos_grid=5), path)
    with pytest.raises(ValueError, match="pos_embed shape"):
        jscalemae.load_mae_weights(jax.device_get(variables), path)
    with pytest.raises(ValueError, match="pos_embed shape"):
        load_sam_weights(port, path, backbone="mae")


@pytest.mark.parametrize("family", ["mae", "scalemae"])
def test_unetr_with_mae_encoder_matches_jax(family):
    """UNETR end to end with an (Scale)MAE encoder, skip connections and ImageNet statistics;
    48x48 one-channel inputs resized to 32 and back (ScaleMAE's grid is its input size's)."""
    jax_cls, port_cls, kwargs = ((jscalemae.MAEViT, MAEViT, MAE) if family == "mae"
                                 else (jscalemae.ScaleMAEViT, ScaleMAEViT, SCALEMAE))
    decoder = dict(img_size=32, out_channels=2, use_mae_stats=True, final_activation="Sigmoid", initial_features=8)
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


@pytest.mark.parametrize("backbone,cls,patch", [("mae", MAEViT, 14), ("scalemae", ScaleMAEViT, 8)])
def test_get_vision_transformer_builds_mae(backbone, cls, patch):
    encoder = get_vision_transformer(backbone, "vit_h", img_size=224, depth=1)
    assert type(encoder) is cls and encoder.patch_size == patch and encoder.embed_dim == 1280
    with pytest.raises(ValueError, match="is not supported by"):
        get_vision_transformer(backbone, "vit_s")
