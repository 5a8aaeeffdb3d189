"""The port's Vision Mamba and ViM-UNet against the JAX package's, on the CPU in float32.

- ``_selective_scan`` against the JAX package's (``lax.associative_scan``) on
  the same (u, delta, A, B, C, D) at sequence lengths 1 to 1025 (the vim_t
  sequence at 512x512), and by gradient against a step-by-step float64 loop;
- ``BiMambaMixerV2`` and ``ViM`` in both variants (embed 32, depth 2) at the
  model's input size and at a smaller one, where the position embedding
  shrinks (the cls slot kept in the middle);
- ``get_vimunet_model`` at the full vim_t width (24 layers, embed 192) on a
  32x32 input, and one training step of a ViM-UNet with a small encoder;
- ``load_vim_weights`` on a hustvl/Vim state dict built here (at another
  grid, so its position embedding is resized) and ``from_checkpoint``.

The weights are the JAX modules', carried over with
``vim_state_dict_from_jax_params`` / ``unetr_state_dict_from_jax_params``
(perturbed from their init's constants). Tolerances: outputs within 1e-4 of
their largest magnitude (2e-4 through the 24 layers of vim_t, where float32
rounding of the two sides drifts apart by up to 1.1e-4); the scan's gradients within 1e-5 relative L2 of the
float64 loop; the training step's loss to rtol 1e-5 and gradients within
1e-3 of their L2 norm plus 1e-6 of the largest gradient's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from torch_em_tpu.loss import DiceLoss as JaxDiceLoss
from torch_em_tpu.models import vim as jvim
from torch_em_tpu.models.unetr import UNETRModule as JaxUNETRModule
import torch_em_tpu_torch as port
from torch_em_tpu_torch.models import vim as pvim
from torch_em_tpu_torch.models import ViM, get_vim_encoder, get_vimunet_model, load_vim_weights
from torch_em_tpu_torch.models.unetr import UNETRModule
from torch_em_tpu_torch.utils.convert import unetr_state_dict_from_jax_params, vim_state_dict_from_jax_params

SMALL = dict(img_size=64, embed_dim=32, depth=2, feature_indexes=(0, 1))
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


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def _perturbed(flat, seed=1, scale=0.05):
    rng = np.random.default_rng(seed)
    return {k: v + rng.normal(size=v.shape).astype(np.float32) * scale for k, v in flat.items()}


def _scan_inputs(length, seed, e=6, n=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(length, e)), rng.uniform(0.01, 1.0, (length, e)), -rng.uniform(0.1, 2.0, (e, n)),
            rng.normal(size=(length, n)), rng.normal(size=(length, n)), rng.normal(size=e))


@pytest.mark.parametrize("length", [1, 2, 3, 8, 37, 1025])
def test_selective_scan_matches_jax(length):
    inputs = [a.astype(np.float32) for a in _scan_inputs(length, length)]
    expected = jvim._selective_scan(*map(jnp.asarray, inputs))
    _assert_close(pvim._selective_scan(*map(torch.from_numpy, inputs)).numpy(), expected)


def test_selective_scan_batches_over_leading_axes():
    """Two directions and a batch in one call equal the per-sequence calls."""
    per = [[torch.from_numpy(a.astype(np.float32)) for a in _scan_inputs(9, s)] for s in range(4)]
    stacked = [torch.stack(t).reshape((2, 2) + t[0].shape) for t in zip(*per)]
    u, delta, A, B, C, D = stacked
    got = pvim._selective_scan(u, delta, A[:, :1], B, C, D[:, :1])
    for i, single in enumerate(per):
        d, b = divmod(i, 2)
        ref = pvim._selective_scan(single[0], single[1], per[2 * d][2], single[3], single[4], per[2 * d][5])
        torch.testing.assert_close(got[d, b], ref, rtol=0, atol=1e-5)


def _scan_loop(u, delta, A, B, C, D):
    """The recurrence one step at a time."""
    h = torch.zeros_like(A)
    ys = []
    for t in range(u.shape[0]):
        h = torch.exp(delta[t][:, None] * A) * h + (delta[t] * u[t])[:, None] * B[t][None, :]
        ys.append(h @ C[t] + D * u[t])
    return torch.stack(ys)


def test_selective_scan_gradients_match_a_float64_loop():
    inputs = _scan_inputs(37, 5)
    weights = torch.from_numpy(np.random.default_rng(6).normal(size=(37, 6)))
    grads = []
    for dtype, fn in ((torch.float64, _scan_loop), (torch.float32, pvim._selective_scan)):
        tensors = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in inputs]
        (fn(*tensors) * weights.to(dtype)).sum().backward()
        grads.append([t.grad.double() for t in tensors])
    for name, got, expected in zip("u delta A B C D".split(), grads[1], grads[0]):
        assert float((got - expected).norm() / expected.norm()) < 1e-5, name


def test_bimamba_mixer_matches_jax():
    rng = np.random.default_rng(2)
    hidden, residual = (rng.normal(size=(2, 9, 32)).astype(np.float32) for _ in range(2))
    mixer = jvim.BiMambaMixerV2(32)
    flat = _perturbed(_flat(mixer.init(jax.random.PRNGKey(0), jnp.asarray(hidden), jnp.asarray(residual))["params"]))
    out, res = mixer.apply({"params": _tree(flat)}, jnp.asarray(hidden), jnp.asarray(residual))
    layer = pvim.BiMambaMixerV2(32)
    state = vim_state_dict_from_jax_params({"block0/" + k: v for k, v in flat.items()})
    layer.load_state_dict({k[len("layers.0."):]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got, got_res = layer(torch.from_numpy(hidden), torch.from_numpy(residual))
    _assert_close(got.numpy(), out)
    _assert_close(got_res.numpy(), res)


@pytest.fixture(scope="module", params=["hustvl", "native"])
def vim_pair(request):
    jax_vim = jvim.ViM(variant=request.param, **SMALL)
    variables = jax.jit(jax_vim.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)))
    flat = _perturbed(_flat(variables["params"]))
    model = ViM(variant=request.param, **SMALL)
    model.load_state_dict(vim_state_dict_from_jax_params(flat), strict=True)
    return jax_vim, {"params": _tree(flat)}, model.eval()


@pytest.mark.parametrize("size", [64, 48], ids=["img_size", "shrinking-position-embedding"])
def test_vim_matches_jax(vim_pair, size):
    jax_vim, variables, model = vim_pair
    x = np.random.default_rng(size).normal(size=(2, 3, size, size)).astype(np.float32)
    out, feats = jax.jit(jax_vim.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got, got_feats = model(torch.from_numpy(x))
    assert got.shape == out.shape == (2, 32, size // 16, size // 16)
    _assert_close(got.numpy(), out)
    for a, b in zip(got_feats, feats):
        _assert_close(a.numpy(), b)


def test_interp_flat_pos_matches_jax():
    pos = np.random.default_rng(3).normal(size=(1, 17, 8)).astype(np.float32)
    for n_out in (5, 17, 37):
        _assert_close(pvim._interp_flat_pos(torch.from_numpy(pos), n_out).numpy(),
                      jvim._interp_flat_pos(jnp.asarray(pos), n_out), 1e-6)


def test_vimunet_model_matches_jax():
    """The recipe's model at its full width: vim_t (24 layers, embed 192), decoder of 64 initial
    features, on a 32x32 input (a 2x2 patch grid and the cls token)."""
    kwargs = dict(out_channels=2, model_type="vim_t", img_size=32, final_activation="Sigmoid")
    jax_model = jvim.get_vimunet_model(**kwargs)
    params = _perturbed({k: v for k, v in _flat(jax_model.variables["params"]).items()}, scale=0.02)
    stats = _flat(jax_model.variables["batch_stats"])
    model = get_vimunet_model(**kwargs, device="cpu")
    assert model.factory == "torch_em_tpu_torch.models.vim.get_vimunet_model"
    model.load_state_dict(unetr_state_dict_from_jax_params(params, stats), strict=True)
    x = np.random.default_rng(4).normal(size=(1, 1, 32, 32)).astype(np.float32)
    expected = jax.jit(jax_model.module.apply)({"params": _tree(params), "batch_stats": _tree(stats)}, jnp.asarray(x))
    with torch.no_grad():
        _assert_close(model(torch.from_numpy(x)).numpy(), expected, 2 * RTOL)


def test_vimunet_training_step_matches_jax():
    kwargs = dict(img_size=64, out_channels=2, resize_input=False, use_skip_connection=False,
                  final_activation="Sigmoid", initial_features=8)
    jax_module = JaxUNETRModule(**kwargs, encoder_module=jvim.ViM(**SMALL))
    variables = jax.jit(jax_module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)))
    params = _perturbed(_flat(variables["params"]))
    stats = _flat(variables["batch_stats"])
    model = UNETRModule(**kwargs, encoder=ViM(**SMALL)).train()
    model.load_state_dict(unetr_state_dict_from_jax_params(params, stats), strict=True)
    x = np.random.default_rng(5).normal(size=(2, 1, 64, 64)).astype(np.float32)
    y = (np.random.default_rng(6).uniform(size=(2, 2, 64, 64)) > 0.5).astype(np.float32)

    def loss_fn(p):
        pred, _ = jax_module.apply({"params": p, "batch_stats": _tree(stats)}, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        return JaxDiceLoss()(pred, jnp.asarray(y))

    loss_jax, grads = jax.jit(jax.value_and_grad(loss_fn))(_tree(params))
    grads = unetr_state_dict_from_jax_params(_flat(grads))
    loss = port.DiceLoss()(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_jax), rtol=1e-5)
    largest = max(np.linalg.norm(g.numpy()) for g in grads.values())
    for name, p in model.named_parameters():
        expected = grads[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - expected)
        assert err <= 1e-3 * np.linalg.norm(expected) + 1e-6 * largest, (name, err, np.linalg.norm(expected))


def _hustvl_state(flat):
    """A hustvl/Vim checkpoint's state dict from a JAX ViM's weights: the names of
    ``vim_state_dict_from_jax_params`` are hustvl's; a classification head is added."""
    state = dict(vim_state_dict_from_jax_params(flat))
    state["head.weight"], state["head.bias"] = torch.zeros(1000, 32), torch.zeros(1000)
    return state


def test_load_vim_weights_matches_jax(tmp_path):
    """A hustvl/Vim checkpoint at a 4x4 patch grid (17 tokens) into 2x2-grid encoders (5 tokens)."""
    source = jvim.ViM(img_size=64, embed_dim=32, depth=2, feature_indexes=(0, 1))
    flat = _perturbed(_flat(jax.jit(source.init)(jax.random.PRNGKey(1), jnp.zeros((1, 3, 64, 64)))["params"]))
    path = str(tmp_path / "vim_t_midclstok.pth")
    torch.save({"model": _hustvl_state(flat)}, path)

    target = jvim.ViM(img_size=32, embed_dim=32, depth=2, feature_indexes=(0, 1))
    variables = jax.jit(target.init)(jax.random.PRNGKey(2), jnp.zeros((1, 3, 32, 32)))
    loaded = jvim.load_vim_weights(jax.device_get(variables), path)
    encoder = get_vim_encoder("vim_t", img_size=32, embed_dim=32, depth=2, feature_indexes=(0, 1))
    assert load_vim_weights(encoder, path) is encoder
    x = np.random.default_rng(7).normal(size=(1, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        _assert_close(encoder(torch.from_numpy(x))[0].numpy(), jax.jit(target.apply)(loaded, jnp.asarray(x))[0])

    state = _hustvl_state(flat)
    state["layers.5.mixer.D"] = torch.ones(64)
    with pytest.raises(ValueError, match="unmatched"):
        load_vim_weights(encoder, state)


def test_vimunet_loads_hustvl_checkpoint_and_rebuilds_from_trainer(tmp_path):
    """``get_vimunet_model(checkpoint=...)`` loads a hustvl checkpoint into its encoder; a trainer
    checkpoint rebuilds the model (factory, arguments, weights)."""
    source = ViM(img_size=32, embed_dim=192, depth=24)
    source.reset_parameters_from(torch.Generator().manual_seed(3))
    path = str(tmp_path / "vim.pth")
    torch.save({"model": source.state_dict()}, path)
    model = get_vimunet_model(out_channels=1, img_size=32, checkpoint=path, device="cpu")
    assert all(torch.equal(v, model.encoder.state_dict()[k]) for k, v in source.state_dict().items())

    rng = np.random.default_rng(8)
    raw = rng.normal(size=(2, 32, 32)).astype(np.float32)
    ds = port.SegmentationDataset(raw, None, (raw > 0).astype(np.float32), None, patch_shape=(1, 32, 32), ndim=2,
                                  n_samples=2)
    model = get_vimunet_model(out_channels=1, img_size=32, device="cpu")
    trainer = port.default_segmentation_trainer(
        "vimunet", model, port.DataLoader(ds, batch_size=2), port.DataLoader(ds, batch_size=2), learning_rate=1e-4,
        device="cpu", mixed_precision=True, save_root=str(tmp_path))
    trainer.fit(iterations=1)
    rebuilt = port.DefaultTrainer.from_checkpoint(trainer.checkpoint_folder, "latest", device="cpu")
    assert rebuilt.model.factory == model.factory and rebuilt.model.init_kwargs == model.init_kwargs
    saved = trainer.model.state_dict()
    assert all(torch.equal(v, saved[k]) for k, v in rebuilt.model.state_dict().items())
    x = torch.from_numpy(raw[:1, None])
    with torch.no_grad():
        torch.testing.assert_close(rebuilt.model.eval()(x), trainer.model.eval()(x))
