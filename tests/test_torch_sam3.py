"""The port's SAM3 encoder (perception-encoder vitdet) against the JAX package's, on the CPU in float32.

The same seeded numpy inputs and the JAX module's weights (random biases in
place of their init's zeros), carried over with
``sam3_state_dict_from_jax_params``, go through both sides. A small
encoder: embed 32, 4 blocks (1 and 3 global), 2 heads, patch 7, windows of
4, a 28-pixel pretraining grid of 4x4; 56x56 inputs (an 8x8 grid: the table
tiles 2x2, the global blocks' RoPE coordinates scale by 4/8) and 42x42 (6x6:
the table resizes linearly, the windows pad).

``load_sam3_weights`` is held against the JAX loader on a whole-model
checkpoint built here (encoder entries under ``image_encoder.trunk.``, the
MLPs under ``mlp.lin{1,2}``, a (1, 17, C) position table), saved with
``torch.save``; ``strict`` refuses an unmatched tensor on both sides.

Tolerances: forwards within 1e-4 of the largest magnitude (float32 sums in
another order); the RoPE angles exact and the rotation within 1e-6;
gradients within 1e-3 of each tensor's L2 norm.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from torch_em_tpu.models import sam3 as jsam3
from torch_em_tpu.models.unetr import UNETRModule as JaxUNETRModule
from torch_em_tpu_torch.models import Sam3ViT, get_vision_transformer, load_sam_weights
from torch_em_tpu_torch.models import sam3 as psam3
from torch_em_tpu_torch.models.unetr import UNETRModule
from torch_em_tpu_torch.utils.convert import sam3_state_dict_from_jax_params, unetr_state_dict_from_jax_params

RTOL = 1e-4
SMALL = dict(img_size=56, pretrain_img_size=28, patch_size=7, embed_dim=32, depth=4, num_heads=2, mlp_ratio=2.0,
             window_size=4, global_attn_indexes=(1, 3))


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
def _pair():
    module = jsam3.Sam3ViT(**SMALL)
    rng = np.random.default_rng(1)
    flat = {k: v + (rng.normal(size=v.shape).astype(np.float32) * 0.1 if k.endswith("bias") else 0)
            for k, v in _flat(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 56, 56)))["params"]).items()}
    port = Sam3ViT(**SMALL)
    port.load_state_dict(sam3_state_dict_from_jax_params(flat), strict=True)
    return module, {"params": _tree(flat)}, port.eval()


def _check_forward(module, variables, port, x):
    out, feats = jax.jit(module.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got, got_feats = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and len(got_feats) == len(feats) == 2
    _assert_close(got.numpy(), out)
    for g, e in zip(got_feats, feats):
        _assert_close(g.numpy(), e)


@pytest.mark.parametrize("grid,scale", [((4, 4), (1.0, 1.0)), ((6, 8), (2 / 3, 0.5))], ids=["window", "global"])
def test_rope_matches_jax(grid, scale):
    angles = jsam3._axial_rope_angles(*grid, 16, *scale)
    got = psam3._axial_rope_angles(*grid, 16, *scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(angles))
    x = _input((3, grid[0] * grid[1], 16), 4)
    _assert_close(psam3._apply_rope(torch.from_numpy(x), got).numpy(), jsam3._apply_rope(jnp.asarray(x), angles), 1e-6)


@pytest.mark.parametrize("size", [56, 42], ids=["tiled-table", "resized-table"])
def test_sam3_matches_jax(size):
    _check_forward(*_pair(), _input((2, 3, size, size), size))


def test_sam3_gradients_match_jax():
    module, variables, port = _pair()
    rng = np.random.default_rng(7)
    x = _input((2, 3, 42, 42), 8)
    w_out, w_feat = (rng.normal(size=(2, 32, 6, 6)).astype(np.float32) for _ in range(2))

    def loss_fn(params):
        out, feats = module.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(out * w_out) + jnp.sum(feats[0] * w_feat)

    grads = sam3_state_dict_from_jax_params(_flat(jax.jit(jax.grad(loss_fn))(variables["params"])))
    port.zero_grad()
    out, feats = port(torch.from_numpy(x))
    ((out * torch.from_numpy(w_out)).sum() + (feats[0] * torch.from_numpy(w_feat)).sum()).backward()
    for name, p in port.named_parameters():
        expected = grads[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - expected)
        assert err <= 1e-3 * np.linalg.norm(expected) + 1e-7, (name, err, np.linalg.norm(expected))


def test_load_sam3_weights_matches_jax(tmp_path):
    module, variables, _ = _pair()
    port = Sam3ViT(**SMALL).eval()
    rng = np.random.default_rng(9)
    state = {}
    for k, v in port.state_dict().items():
        value = torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32) * 0.2)
        state["image_encoder.trunk." + k.replace(".mlp.fc", ".mlp.lin")] = value
    state["image_encoder.trunk.pos_embed"] = state["image_encoder.trunk.pos_embed"][0]  # (17, C)
    path = str(tmp_path / "sam3.pt")
    torch.save({"model": state}, path)

    loaded, converted, skipped = jsam3.load_sam3_weights(jax.device_get(variables), path)
    assert not skipped and converted == len(state)
    assert load_sam_weights(port, path, backbone="sam3") is port
    _check_forward(module, loaded, port, _input((1, 3, 56, 56), 10))

    state["image_encoder.trunk.blocks.0.extra.weight"] = torch.zeros(3, 3)
    torch.save({"model": state}, path)
    with pytest.raises(ValueError, match="did not map"):
        jsam3.load_sam3_weights(jax.device_get(variables), path)
    with pytest.raises(ValueError, match="unmatched"):
        load_sam_weights(port, path, backbone="sam3")
    with pytest.warns(UserWarning, match="unmatched"):
        load_sam_weights(port, path, backbone="sam3", strict=False)


def test_unetr_with_sam3_encoder_matches_jax():
    """UNETR end to end with the SAM3 encoder, skip connections from its global blocks' features
    (four here, the last three read), one-channel 48x48 inputs resized to 56 and back."""
    small = dict(SMALL, depth=6, global_attn_indexes=(1, 3, 5))
    decoder = dict(img_size=56, out_channels=2, final_activation="Sigmoid", initial_features=8)
    jax_module = JaxUNETRModule(**decoder, encoder_module=jsam3.Sam3ViT(**small))
    variables = jax.jit(jax_module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 56, 56)))
    rng = np.random.default_rng(1)
    stats = {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("var") else rng.normal(size=v.shape) * 0.1)
             .astype(np.float32) for k, v in _flat(variables["batch_stats"]).items()}
    params = _flat(variables["params"])
    model = UNETRModule(Sam3ViT(**small), **decoder).eval()
    model.load_state_dict(unetr_state_dict_from_jax_params(params, stats), strict=True)
    x = _input((2, 1, 48, 48), 11)
    expected = jax.jit(jax_module.apply)({"params": _tree(params), "batch_stats": _tree(stats)}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _assert_close(got.numpy(), expected)


def test_get_vision_transformer_builds_sam3():
    assert get_vision_transformer("sam3", "vit_pe", depth=1).img_size == 1008
    assert get_vision_transformer("sam3", "vit_pe", img_size=504, depth=1).img_size == 504
    with pytest.raises(ValueError, match="vit_pe"):
        get_vision_transformer("sam3", "vit_b")
