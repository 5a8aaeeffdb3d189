"""The port's SAM-geometry ViT against the JAX package's, on the CPU in float32.

The same seeded numpy inputs and the JAX module's weights, carried over with
``vit_state_dict_from_jax_params`` (random relative-position tables in place
of the zeros of their init, so that the bias is exercised), go through both
sides. Small encoders: embed 48, 3 blocks, 64x64 inputs (a 4x4 token grid,
windows of 3 with padding), and 48x48 inputs to a 64 model, where the
position embedding (4 -> 3) and the global blocks' relative-position tables
(7 -> 5 entries) shrink, through the antialiased linear resize.

Tolerances: outputs within 1e-4 relative to their largest magnitude (float32
sums in another order); gradients per tensor within 1e-4 relative L2 (both
sides lie about 1e-6 from float64 here); the rel-pos gathers and window
partitions are exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict, unflatten_dict

from torch_em_tpu.models import vit as jvit
from torch_em_tpu_torch.models import vit as pvit
from torch_em_tpu_torch.models import ViT, get_vision_transformer, load_sam_weights
from torch_em_tpu_torch.utils.convert import vit_state_dict_from_jax_params

SMALL = dict(embed_dim=48, depth=3, num_heads=2, global_attn_indexes=(1,))
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Six test workers' thread pools oversubscribe the CPU; one thread per worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_close(got, expected, rtol=RTOL):
    expected = np.asarray(expected)
    np.testing.assert_allclose(np.asarray(got), expected, rtol=0, atol=rtol * np.abs(expected).max())


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _randomized(flat, seed=1):
    """Random relative-position tables (zeros at init) and position embedding."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=v.shape).astype(np.float32) * 0.2 if ("rel_pos" in k or k == "pos_embed") else v)
            for k, v in flat.items()}


@pytest.fixture(scope="module")
def sam_encoders():
    """A small "sam" encoder on both sides, with the same weights."""
    jax_vit = jvit.get_vision_transformer("sam", "vit_b", img_size=64, window_size=3, **SMALL)
    x = np.zeros((1, 3, 64, 64), np.float32)
    flat = _randomized(_flat(jax_vit.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    port_vit = get_vision_transformer("sam", "vit_b", img_size=64, window_size=3, **SMALL)
    port_vit.load_state_dict(vit_state_dict_from_jax_params(flat), strict=True)
    return jax_vit, {"params": unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})}, port_vit.eval()


@pytest.mark.parametrize("q_size,k_size,table", [(3, 3, 5), (4, 4, 7), (3, 3, 7), (4, 4, 5), (5, 3, 9), (3, 5, 9),
                                                 (32, 32, 63), (28, 28, 63)])
def test_rel_pos_matches_jax(q_size, k_size, table):
    rel_pos = np.random.default_rng(table).normal(size=(table, 6)).astype(np.float32)
    expected = np.asarray(jvit._get_rel_pos(q_size, k_size, jnp.asarray(rel_pos)))
    _assert_close(pvit._get_rel_pos(q_size, k_size, torch.from_numpy(rel_pos)).numpy(), expected, 1e-6)


@pytest.mark.parametrize("hw", [(6, 6), (7, 5), (4, 4)], ids=["no-padding", "padding", "window-fits-once-padded"])
def test_window_partition_matches_jax(hw):
    x = np.random.default_rng(0).normal(size=(2,) + hw + (4,)).astype(np.float32)
    windows, pad_hw = jvit._window_partition(jnp.asarray(x), 3)
    got, got_pad = pvit._window_partition(torch.from_numpy(x), 3)
    assert got_pad == pad_hw
    np.testing.assert_array_equal(got.numpy(), np.asarray(windows))
    back = pvit._window_unpartition(got, 3, got_pad, hw)
    np.testing.assert_array_equal(back.numpy(), x)


def test_decomposed_bias_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 20, 8)).astype(np.float32)
    attn = np.zeros((3, 20, 20), np.float32)
    rel_h, rel_w = (rng.normal(size=(9, 8)).astype(np.float32) for _ in range(2))
    expected = jvit._add_decomposed_rel_pos(jnp.asarray(attn), jnp.asarray(q), jnp.asarray(rel_h),
                                            jnp.asarray(rel_w), (4, 5), (4, 5))
    got = pvit._decomposed_rel_pos_bias(torch.from_numpy(q), torch.from_numpy(rel_h), torch.from_numpy(rel_w),
                                        (4, 5), (4, 5))
    _assert_close(got.numpy(), expected, 1e-6)


def test_sdpa_with_bias_matches_plain_attention():
    """The card's route (scaled_dot_product_attention with an additive bias) and the plain
    version compute the same function; here both on the CPU in float32."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, 20, 8)).astype(np.float32)) for _ in range(3))
    bias = torch.from_numpy(rng.normal(size=(2, 3, 20, 20)).astype(np.float32))
    expected = pvit._attention_plain(q, k, v, bias)
    _assert_close(F.scaled_dot_product_attention(q, k, v, attn_mask=bias).numpy(), expected.numpy(), 1e-5)
    _assert_close(pvit._attention(q, k, v, bias).numpy(), expected.numpy(), 0)


@pytest.mark.parametrize("window_size", [3, 0], ids=["windowed", "global"])
def test_block_matches_jax(window_size):
    block = jvit._Block(2, window_size=window_size, use_rel_pos=True, grid_size=5)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 5, 16)).astype(np.float32)
    flat = _randomized({"block0/" + k: v for k, v in
                        _flat(block.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]).items()})
    expected = block.apply({"params": unflatten_dict({tuple(k.split("/")[1:]): v for k, v in flat.items()})},
                           jnp.asarray(x))
    port = pvit._Block(16, 2, window_size=window_size, use_rel_pos=True, rel_pos_size=window_size or 5)
    port.load_state_dict({k[len("blocks.0."):]: v for k, v in vit_state_dict_from_jax_params(flat).items()},
                         strict=True)
    with torch.no_grad():
        _assert_close(port(torch.from_numpy(x)).numpy(), expected)


@pytest.mark.parametrize("size", [64, 48], ids=["img_size", "shrinking-resizes"])
@pytest.mark.parametrize("apply_neck", [True, False], ids=["neck", "raw-features"])
def test_vit_matches_jax(sam_encoders, size, apply_neck):
    jax_vit, variables, port_vit = sam_encoders
    x = np.random.default_rng(size).normal(size=(2, 3, size, size)).astype(np.float32)
    out, feats = jax_vit.clone(apply_neck=apply_neck).apply(variables, jnp.asarray(x))
    port_vit.apply_neck = apply_neck
    with torch.no_grad():
        got, got_feats = port_vit(torch.from_numpy(x))
    port_vit.apply_neck = True
    assert got.dtype == torch.float32 and got.shape == out.shape
    _assert_close(got.numpy(), out)
    assert len(got_feats) == len(feats) == 1
    _assert_close(got_feats[0].numpy(), feats[0])


def test_vit_gradients_match_jax(sam_encoders):
    jax_vit, variables, port_vit = sam_encoders
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 48, 48)).astype(np.float32)
    # fixed random projections of the outputs (a mean of squares of a layer norm's output is
    # nearly constant, and its gradient rounding noise)
    w_out, w_feat = (rng.normal(size=(2, c, 3, 3)).astype(np.float32) for c in (256, 48))

    def loss_fn(params):
        out, feats = jax_vit.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(out * w_out) + jnp.sum(feats[0] * w_feat)

    grads = vit_state_dict_from_jax_params(_flat(jax.grad(loss_fn)(variables["params"])))
    port_vit.zero_grad()
    out, feats = port_vit(torch.from_numpy(x))
    ((out * torch.from_numpy(w_out)).sum() + (feats[0] * torch.from_numpy(w_feat)).sum()).backward()
    for name, p in port_vit.named_parameters():
        expected = grads[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - expected) / max(np.linalg.norm(expected), 1e-12)
        assert err < 1e-4, (name, err)


def test_cellpose_sam_matches_jax():
    """All blocks global over an 8-pixel patch grid, the rel-pos tables kept at SAM's 14 and
    resized at call time (here 27 -> 7 entries)."""
    kwargs = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,))
    jax_vit = jvit.get_vision_transformer("cellpose_sam", "vit_l", img_size=32, **kwargs)
    x = np.random.default_rng(8).normal(size=(1, 3, 32, 32)).astype(np.float32)
    flat = _randomized(_flat(jax_vit.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]))
    out, _ = jax_vit.apply({"params": unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})},
                           jnp.asarray(x))
    port_vit = get_vision_transformer("cellpose_sam", "vit_l", img_size=32, **kwargs)
    assert port_vit.patch_embed.proj.kernel_size == (8, 8)
    port_vit.load_state_dict(vit_state_dict_from_jax_params(flat), strict=True)
    with torch.no_grad():
        _assert_close(port_vit(torch.from_numpy(x))[0].numpy(), out)


@pytest.mark.parametrize("backbone", ["sam2", "sam3", "mae", "scalemae", "dinov2", "dinov3"])
def test_unported_backbones_raise(backbone):
    """The families that the port once refused build their own encoder class, as the JAX
    package's ``get_vision_transformer`` routes them; an unknown model name raises its error."""
    from torch_em_tpu_torch import models

    model, cls = {"sam2": ("hvit_b", models.HieraSam2), "sam3": ("vit_pe", models.Sam3ViT),
                  "mae": ("vit_b", models.MAEViT), "scalemae": ("vit_b", models.ScaleMAEViT),
                  "dinov2": ("vit_b", models.DinoV2ViT), "dinov3": ("vit_b", models.DinoV3ViT)}[backbone]
    depth = dict(stages=(1, 1, 1, 1), global_att_blocks=()) if backbone == "sam2" else dict(depth=1)
    encoder = get_vision_transformer(backbone, model, img_size=224, **depth)
    assert type(encoder) is cls and type(jvit.get_vision_transformer(backbone, model, img_size=224)).__name__ == \
        cls.__name__
    with pytest.raises(ValueError):
        jvit.get_vision_transformer(backbone, "vit_unknown")
    with pytest.raises(ValueError):
        get_vision_transformer(backbone, "vit_unknown")


def test_unknown_backbone_raises():
    with pytest.raises(ValueError, match="Unknown backbone"):
        jvit.get_vision_transformer("sam4")
    with pytest.raises(ValueError, match="Unknown backbone"):
        get_vision_transformer("sam4")


def test_load_sam_weights_matches_jax(sam_encoders, tmp_path):
    """A segment-anything checkpoint built here (a whole SAM model's ``image_encoder.`` entries
    beside its decoders' and the neck) loads into both sides to the same function."""
    jax_vit, variables, _ = sam_encoders
    rng = np.random.default_rng(9)
    state = {f"image_encoder.{k}": v + torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)) * 0.05
             for k, v in vit_state_dict_from_jax_params(_flat(variables["params"])).items()}
    state["mask_decoder.iou_token.weight"] = torch.zeros(1, 4)
    state["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = torch.zeros(2, 4)
    path = str(tmp_path / "sam.pth")
    torch.save(state, path)

    loaded = jvit.load_sam_weights(jax.device_get(variables), path)
    port_vit = get_vision_transformer("sam", "vit_b", img_size=64, window_size=3, **SMALL)
    assert load_sam_weights(port_vit, path) is port_vit
    x = np.random.default_rng(10).normal(size=(1, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        _assert_close(port_vit(torch.from_numpy(x))[0].numpy(), jax_vit.apply(loaded, jnp.asarray(x))[0])

    state["image_encoder.blocks.9.attn.qkv.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="unmatched"):
        load_sam_weights(port_vit, state)
    with pytest.warns(UserWarning, match="unmatched"):
        load_sam_weights(port_vit, state, strict=False)


def test_vit_computes_in_bfloat16():
    """The model's dtype casts the input; parameters stay float32; outputs are float32."""
    model = ViT(img_size=32, embed_dim=16, depth=2, num_heads=2, global_attn_indexes=(1,), window_size=2,
                use_rel_pos=True, dtype=torch.bfloat16)
    model.reset_parameters_from(torch.Generator().manual_seed(0))
    out, feats = model(torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(1)))
    assert out.dtype == feats[0].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert torch.isfinite(out).all()
