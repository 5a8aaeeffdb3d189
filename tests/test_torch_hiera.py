"""The port's SAM2 encoder (Hiera trunk and FPN neck) against the JAX package's, on the CPU in float32.

The same seeded numpy inputs and the JAX module's weights (random biases in
place of their init's zeros), carried over with
``hiera_state_dict_from_jax_params``, go through both sides. A small Hiera:
embed 8, one head, stages (1, 1, 3, 1) with query pooling at every stage
start, windows (4, 4, 3, 2) (stage 3's windows of 3 pad its 4x4 and 2x2
grids), block 4 global, a 10x10 background position table, ``d_model`` 16;
64x64 inputs (a 16x16 grid: the table grows through torch's bicubic) and
32x32 (8x8: it shrinks).

``load_sam2_weights`` is held against the JAX loader on a whole sam2
checkpoint built here (``image_encoder.`` entries beside the memory and
decoder tensors and the neck's position encoding, neck convs under both
names), saved with ``torch.save``; ``strict`` refuses an unmatched tensor
on both sides.

Tolerances: forwards within 1e-4 of the largest magnitude (float32 sums in
another order); gradients within 1e-3 of each tensor's L2 norm; the block
schedule and the max pool are exact.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from torch_em_tpu.models import hiera as jhiera
from torch_em_tpu.models.unetr import UNETRModule as JaxUNETRModule
from torch_em_tpu_torch.models import UNETR, HieraSam2, get_vision_transformer, load_sam_weights
from torch_em_tpu_torch.models import hiera as phiera
from torch_em_tpu_torch.models.unetr import UNETRModule
from torch_em_tpu_torch.utils.convert import hiera_state_dict_from_jax_params, unetr_state_dict_from_jax_params

RTOL = 1e-4
SMALL = dict(img_size=64, embed_dim=8, num_heads=1, stages=(1, 1, 3, 1), global_att_blocks=(4,),
             window_pos_embed_bkg_spatial_size=(10, 10), window_spec=(4, 4, 3, 2), d_model=16)


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
    module = jhiera.HieraSam2(**SMALL)
    rng = np.random.default_rng(1)
    flat = {k: v + (rng.normal(size=v.shape).astype(np.float32) * 0.1 if k.endswith("bias") else 0)
            for k, v in _flat(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)))["params"]).items()}
    port = HieraSam2(**SMALL)
    port.load_state_dict(hiera_state_dict_from_jax_params(flat), strict=True)
    return module, {"params": _tree(flat)}, port.eval()


def _check_forward(module, variables, port, x):
    out, feats = jax.jit(module.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got, got_feats = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and len(got_feats) == len(feats) == 3
    assert got.shape[1] == port.out_chans == 16 and got.shape[-1] == x.shape[-1] // 16
    _assert_close(got.numpy(), out)
    for g, e in zip(got_feats, feats):
        _assert_close(g.numpy(), e)


@pytest.mark.parametrize("name", ["hvit_t", "hvit_s", "hvit_b", "hvit_l"])
def test_block_schedule_matches_jax(name):
    cfg = phiera.HIERA_CONFIGS[name]
    defaults = {k: getattr(jhiera.HieraSam2, k) for k in ("stages", "global_att_blocks", "window_spec", "q_pool",
                                                          "dim_mul", "head_mul")}
    args = {k: cfg.get(k, v) for k, v in defaults.items()}
    expected, ends = jhiera._hiera_block_configs(cfg["embed_dim"], cfg["num_heads"], **args)
    got, got_ends = phiera._hiera_block_configs(cfg["embed_dim"], cfg["num_heads"], **args)
    assert got_ends == ends
    assert [{k: v for k, v in c.items() if k != "dim"} for c in got] == expected


@pytest.mark.parametrize("hw", [(8, 8), (7, 5)], ids=["even", "floor"])
def test_max_pool_matches_jax(hw):
    x = _input((2,) + hw + (3,), 2)
    np.testing.assert_array_equal(phiera._max_pool(torch.from_numpy(x), (2, 2)).numpy(),
                                  np.asarray(jhiera._max_pool_2x2(jnp.asarray(x), (2, 2))))


@pytest.mark.parametrize("size", [64, 32], ids=["grown-table", "shrunk-table"])
def test_hiera_matches_jax(size):
    _check_forward(*_pair(), _input((2, 3, size, size), size))


def test_hiera_gradients_match_jax():
    module, variables, port = _pair()
    rng = np.random.default_rng(7)
    x = _input((2, 3, 64, 64), 8)
    # a fixed random projection of every level (the neck conv of H / 8 feeds only its own)
    w = [rng.normal(size=(2, 16, s, s)).astype(np.float32) for s in (4, 16, 8)]

    def loss_fn(params):
        out, feats = module.apply({"params": params}, jnp.asarray(x))
        return sum(jnp.sum(t * wt) for t, wt in zip([out, feats[0], feats[1]], w))

    grads = hiera_state_dict_from_jax_params(_flat(jax.jit(jax.grad(loss_fn))(variables["params"])))
    port.zero_grad()
    out, feats = port(torch.from_numpy(x))
    sum((t * torch.from_numpy(wt)).sum() for t, wt in zip([out, feats[0], feats[1]], w)).backward()
    for name, p in port.named_parameters():
        expected = grads[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - expected)
        assert err <= 1e-3 * np.linalg.norm(expected) + 1e-7, (name, err, np.linalg.norm(expected))


def test_load_sam2_weights_matches_jax(tmp_path):
    module, variables, _ = _pair()
    port = HieraSam2(**SMALL).eval()
    rng = np.random.default_rng(9)
    state = {}
    for k, v in port.state_dict().items():
        value = torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32) * 0.2)
        if k.startswith("neck.convs.0.conv."):  # sam2's plain Conv2d name beside its ConvNormAct one
            k = k.replace(".conv.", ".")
        state[f"image_encoder.{k}"] = value
    state.update({"image_encoder.neck.position_encoding.cache": torch.zeros(2), "maskmem_tpos_enc": torch.zeros(3),
                  "memory_attention.layers.0.weight": torch.zeros(2, 2),
                  "sam_mask_decoder.iou_token.weight": torch.zeros(1, 4)})
    path = str(tmp_path / "sam2.pt")
    torch.save({"model": state}, path)

    loaded = jhiera.load_sam2_weights(jax.device_get(variables), path)
    assert load_sam_weights(port, path, backbone="sam2") is port
    _check_forward(module, loaded, port, _input((1, 3, 64, 64), 10))

    state["image_encoder.trunk.blocks.0.extra.weight"] = torch.zeros(3, 3)
    torch.save({"model": state}, path)
    with pytest.raises(ValueError, match="unmatched"):
        jhiera.load_sam2_weights(jax.device_get(variables), path)
    with pytest.raises(ValueError, match="unmatched"):
        load_sam_weights(port, path, backbone="sam2")
    with pytest.warns(UserWarning, match="unmatched"):
        load_sam_weights(port, path, backbone="sam2", strict=False)


def test_unetr_with_sam2_encoder_matches_jax():
    """UNETR end to end with the Hiera encoder and no skip connections (its features at H / 16,
    the deconvolution chain), 48x48 one-channel inputs resized to 64 and back."""
    decoder = dict(img_size=64, out_channels=2, use_skip_connection=False, final_activation="Sigmoid",
                   initial_features=8)
    jax_module = JaxUNETRModule(**decoder, encoder_module=jhiera.HieraSam2(**SMALL))
    variables = jax.jit(jax_module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)))
    rng = np.random.default_rng(1)
    stats = {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("var") else rng.normal(size=v.shape) * 0.1)
             .astype(np.float32) for k, v in _flat(variables["batch_stats"]).items()}
    params = _flat(variables["params"])
    model = UNETRModule(HieraSam2(**SMALL), **decoder).eval()
    model.load_state_dict(unetr_state_dict_from_jax_params(params, stats), strict=True)
    x = _input((2, 1, 48, 48), 11)
    expected = jax.jit(jax_module.apply)({"params": _tree(params), "batch_stats": _tree(stats)}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _assert_close(got.numpy(), expected)


def test_unetr_factory_builds_sam2():
    model = UNETR(img_size=64, backbone="sam2", encoder="hvit_t", out_channels=2, use_skip_connection=False,
                  device="cpu", stages=(1, 1, 1, 1), global_att_blocks=(2,))
    assert type(model.encoder) is HieraSam2 and model.encoder.embed_dim == 96
    assert model.base.block[1].weight.shape[1] == 256  # the decoder reads d_model channels
    with torch.no_grad():
        assert model(torch.zeros(1, 1, 64, 64)).shape == (1, 2, 64, 64)
    with pytest.raises(ValueError, match="is not supported by SAM2"):
        get_vision_transformer("sam2", "vit_b")
