"""The port's UNETR (2D and 3D) against the JAX package's, on the CPU in float32.

Both sides hold the same weights, the JAX model's carried over with
``unetr_state_dict_from_jax_params`` / ``unetr3d_state_dict_from_jax_params``
(random batch-norm statistics and affine parameters and relative-position
tables in place of their init's constants). The 2-D models are the JAX
``UNETRModule`` (the port's and the JAX package's) with a small SAM-geometry
ViT (embed 48, 4 blocks, the last three global, windows of 3 on a 4x4 token
grid) and a decoder of 8 initial features; the factories build the same
modules (the port's is checked for its arguments and seeding). The inputs
are one-channel (repeated to three), 64x64 and 48x48 (with ``resize_input`` resized to 64 and the
masks back to 48, a shrink; without it the position embedding and the global
relative-position tables shrink). Both decoder wirings run, the one with
skip connections crops its skips' channels. ``UNETR3D`` runs a vit_t
encoder with its neck on two slices of 32x32, with and without strip pooling
(and with it on 24x24, resized to 32 and back).

Tolerances: outputs within 1e-4 of their largest magnitude (float32 sums in
another order); one training step's loss (batch statistics in the
deconvolutions' norms) to rtol 1e-5, and each gradient within 1e-3 of its L2
norm plus 1e-6 of the largest gradient's (the gradients agree to about 2e-5;
the biases of convs that a norm follows hold rounding noise on both sides).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from torch_em_tpu.loss import DiceLoss as JaxDiceLoss
from torch_em_tpu.models.unetr import UNETR3DModule as JaxUNETR3DModule, UNETRModule as JaxUNETRModule
from torch_em_tpu.models.vit import ViT as JaxViT
import torch_em_tpu_torch as port
from torch_em_tpu_torch.models import UNETR, UNETR2D, UNETR3D, DepthStripPooling, ViT
from torch_em_tpu_torch.models.unetr import UNETRModule
from torch_em_tpu_torch.utils.convert import unetr3d_state_dict_from_jax_params, unetr_state_dict_from_jax_params

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


def _randomized(variables, seed=1):
    """Flattened params and batch_stats, with random norms' statistics and affines and
    relative-position tables."""
    rng = np.random.default_rng(seed)
    params = {k: (rng.normal(size=v.shape).astype(np.float32) * 0.1 + (k.endswith("scale") and "bn" in k)
                  if ("rel_pos" in k or "bn" in k) else v) for k, v in _flat(variables["params"]).items()}
    stats = {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("var") else rng.normal(size=v.shape) * 0.1)
             .astype(np.float32) for k, v in _flat(variables.get("batch_stats", {})).items()}
    return params, stats


def _assert_gradients_close(model, expected_grads):
    """Each parameter's gradient within 1e-3 of its L2 norm, plus 1e-6 of the largest
    gradient's norm: the biases of convs that a norm follows have a true gradient of zero, and
    both sides hold rounding noise there (norms of 1e-9 against 1e-2)."""
    largest = max(np.linalg.norm(g.numpy()) for g in expected_grads.values())
    for name, p in model.named_parameters():
        expected = expected_grads[name].numpy()
        if p.grad is None:  # the encoder's neck, whose output UNETR does not read
            assert name.startswith("encoder.neck.") and not expected.any(), name
            continue
        err = np.linalg.norm(p.grad.numpy() - expected)
        assert err <= 1e-3 * np.linalg.norm(expected) + 1e-6 * largest, (name, err, np.linalg.norm(expected))


def _input(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


ENCODER = dict(img_size=64, embed_dim=48, depth=4, num_heads=2, global_attn_indexes=(1, 2, 3), window_size=3,
               use_rel_pos=True, use_neck=True, apply_neck=False)


@pytest.fixture(scope="module", params=[True, False], ids=["skip", "no-skip"])
def unetr_pair(request):
    skip = request.param
    kwargs = dict(img_size=64, out_channels=2, use_skip_connection=skip, final_activation="Sigmoid",
                  initial_features=8)
    jax_module = JaxUNETRModule(**kwargs, encoder_module=JaxViT(**ENCODER))
    variables = jax.jit(jax_module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)))
    params, stats = _randomized(variables)
    model = UNETRModule(**kwargs, encoder=ViT(**ENCODER)).eval()
    model.load_state_dict(unetr_state_dict_from_jax_params(params, stats), strict=True)
    return jax_module, {"params": _tree(params), "batch_stats": _tree(stats)}, model


@pytest.mark.parametrize("size,resize_input", [(64, True), (48, True), (48, False)],
                         ids=["img_size", "resize-in-and-back", "shrinking-encoder-resizes"])
def test_unetr_matches_jax(unetr_pair, size, resize_input):
    jax_module, variables, model = unetr_pair
    x = _input((2, 1, size, size), size)
    expected = jax.jit(jax_module.clone(resize_input=resize_input).apply)(variables, jnp.asarray(x))
    model.resize_input = resize_input
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    model.resize_input = True
    assert got.shape == expected.shape == (2, 2, size, size) and got.dtype == torch.float32
    _assert_close(got.numpy(), expected)


def test_unetr_training_step_matches_jax(unetr_pair):
    """One step's Dice loss and gradients, batch statistics in the deconvolutions' norms."""
    jax_module, variables, model = unetr_pair
    x = _input((2, 1, 64, 64), 3)
    y = (np.random.default_rng(4).uniform(size=(2, 2, 64, 64)) > 0.5).astype(np.float32)

    def loss_fn(params):
        pred, _ = jax_module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jnp.asarray(x), train=True, mutable=["batch_stats"])
        return JaxDiceLoss()(pred, jnp.asarray(y))

    loss_jax, grads_jax = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    grads_jax = unetr_state_dict_from_jax_params(_flat(grads_jax))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    model.zero_grad()
    loss = port.DiceLoss()(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    model.eval()
    np.testing.assert_allclose(float(loss.detach()), float(loss_jax), rtol=1e-5)
    _assert_gradients_close(model, grads_jax)
    model.load_state_dict(state)  # the running statistics moved


def test_unetr2d_is_unetr_and_records_its_factory():
    model = UNETR2D(img_size=32, encoder="vit_t", out_channels=1, device="cpu", seed=3)
    assert UNETR2D is UNETR and model.factory == "torch_em_tpu_torch.models.unetr.UNETR"
    assert model.init_kwargs["seed"] == 3 and model.init_kwargs["device"] == "cpu"
    again = UNETR(img_size=32, encoder="vit_t", out_channels=1, device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), again.state_dict().values()))


@pytest.mark.parametrize("use_strip_pooling", [True, False], ids=["strip-pooling", "no-strip-pooling"])
def test_unetr3d_matches_jax(use_strip_pooling):
    kwargs = dict(img_size=32, out_channels=2, use_strip_pooling=use_strip_pooling)
    jax_module = JaxUNETR3DModule(encoder_name="vit_t", **kwargs)
    params, stats = _randomized(jax.jit(jax_module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 2, 32, 32))))
    model = UNETR3D(encoder="vit_t", **kwargs, device="cpu")
    model.load_state_dict(unetr3d_state_dict_from_jax_params(params, stats), strict=True)
    variables = {"params": _tree(params), "batch_stats": _tree(stats)} if stats else {"params": _tree(params)}
    for size in (32, 24) if use_strip_pooling else (32,):
        x = _input((1, 1, 2, size, size), size)
        expected = jax.jit(jax_module.apply)(variables, jnp.asarray(x))
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        assert got.shape == expected.shape == (1, 2, 2, size, size)
        _assert_close(got.numpy(), expected)


def test_unetr3d_refuses_skip_connections():
    with pytest.raises(NotImplementedError):
        UNETR3D(img_size=32, encoder="vit_t", use_skip_connection=True, device="cpu")


def test_depth_strip_pooling():
    """A gated residual from the depth mean; a no-op on one slice."""
    pool = DepthStripPooling(8).train()
    generator = torch.Generator().manual_seed(1)
    pool.conv1.reset_parameters(generator)
    pool.conv2.reset_parameters(generator)
    x = torch.randn(2, 8, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(pool(x[:, :, :1]), x[:, :, :1])
    feat = torch.relu(pool.bn1(pool.conv1(x.mean(2, keepdim=True))))
    torch.testing.assert_close(pool(x), x * torch.sigmoid(pool.conv2(feat)) + x)


def test_unetr_from_checkpoint_rebuilds_the_model(tmp_path):
    """A trainer checkpoint rebuilds the UNETR (factory and arguments) with its weights."""
    rng = np.random.default_rng(5)
    raw = rng.normal(size=(2, 64, 64)).astype(np.float32)
    labels = (raw > 0).astype(np.float32)
    ds = port.SegmentationDataset(raw, None, labels, None, patch_shape=(1, 32, 32), ndim=2, n_samples=2)
    model = UNETR(img_size=32, encoder="vit_t", out_channels=1, final_activation="Sigmoid", device="cpu")
    trainer = port.default_segmentation_trainer(
        "unetr", model, port.DataLoader(ds, batch_size=2), port.DataLoader(ds, batch_size=2), learning_rate=1e-4,
        device="cpu", mixed_precision=True, save_root=str(tmp_path))
    trainer.fit(iterations=1)
    rebuilt = port.DefaultTrainer.from_checkpoint(trainer.checkpoint_folder, "latest", device="cpu")
    assert type(rebuilt.model) is type(model) and rebuilt.model.init_kwargs == model.init_kwargs
    saved = trainer.model.state_dict()
    assert all(torch.equal(v, saved[k]) for k, v in rebuilt.model.state_dict().items())
    assert rebuilt.model.dtype == torch.float32 and rebuilt.model.encoder.dtype == torch.float32


def test_unetr3d_spec_rebuilds_the_model():
    """The constructor spec that a trainer checkpoint stores (``init`` in ``from_checkpoint``)
    rebuilds UNETR3D with the same seeded weights."""
    from torch_em_tpu_torch.trainer.serialization import deserialize_value, serialize_value

    model = UNETR3D(img_size=32, encoder="vit_t", out_channels=2, depth=2, embed_dim=48, num_heads=2,
                    global_attn_indexes=(1,), device="cpu", seed=4)
    rebuilt = deserialize_value(serialize_value(model))
    assert type(rebuilt) is type(model) and rebuilt.init_kwargs == model.init_kwargs
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in rebuilt.state_dict().items())
