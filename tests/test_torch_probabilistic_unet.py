"""The port's Probabilistic U-Net, its losses and its trainer against the JAX package's.

Both sides take the same seeded numpy inputs on the CPU in float32, with the
JAX weights carried over by ``utils.convert``; the port's noise is the
standard-normal draw that JAX makes from its key. Tolerances: outputs 1e-5
of the largest value; gradients per tensor within 1e-3 of their L2 norm plus
1e-6 of the largest element (biases that a norm follows hold rounding noise
on both sides); parameters after a clipped SGD step within 1e-6 (SGD keeps
the gradients' agreement in the step and shows the clip; AdamW's first step
divides each gradient by its own magnitude, which hides the clip, and
AdamW itself is held by ``tests/test_torch_optim.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from torch_em_tpu.models.probabilistic_unet import ProbabilisticUNetModel as JaxModel
from torch_em_tpu.models.probabilistic_unet import ProbabilisticUNetModule as JaxModule
from torch_em_tpu.self_training import loss as jax_loss
from torch_em_tpu_torch.models import ProbabilisticUNet
from torch_em_tpu_torch.self_training import loss
from torch_em_tpu_torch.utils.convert import probabilistic_unet_state_dict_from_jax_params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers; torch's thread pool in each would oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CONFIG = dict(num_filters=[4, 8], latent_dim=3)
SHAPE = (2, 1, 32, 32)
VALUE_TOL, GRAD_TOL, GRAD_ATOL_OF_MAX = 1e-5, 1e-3, 1e-6


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(tree), sep="/").items()}


@pytest.fixture(scope="module")
def setup():
    # the JAX factory's model, initialised under jit (its eager init takes half a minute here)
    module = JaxModule(input_channels=1, num_classes=1, num_filters=tuple(CONFIG["num_filters"]),
                       latent_dim=CONFIG["latent_dim"])
    example = jnp.zeros((1, 1, 4, 4))
    jax_model = JaxModel(module, init_kwargs={}, example_input_shape=example.shape, in_channels=1, out_channels=1,
                         eager_init=False)
    jax_model.variables = jax.jit(lambda rng, x: module.init(rng, x, train=False))(jax.random.PRNGKey(0), example)
    state = probabilistic_unet_state_dict_from_jax_params(_flat(jax_model.variables["params"]))
    rng = np.random.default_rng(0)
    x = rng.normal(size=SHAPE).astype(np.float32)
    y = (rng.random(SHAPE) > 0.6).astype(np.float32)
    consm = (rng.random(SHAPE) > 0.3).astype(np.float32)
    return jax_model, state, x, y, consm


def _port(state, **kwargs):
    model = ProbabilisticUNet(**CONFIG, device="cpu", **kwargs)
    model.load_state_dict(state, strict=True)
    return model


def _close(got, expected):
    expected = np.asarray(expected)
    np.testing.assert_allclose(got.detach().numpy(), expected, rtol=0,
                               atol=VALUE_TOL * max(1.0, float(np.abs(expected).max())))


def _noise(key, n, latent=CONFIG["latent_dim"]):
    return torch.from_numpy(np.array(jax.random.normal(key, (n, latent))))


def test_encode_reconstruct_and_prior_mean(setup):
    jax_model, state, x, y, _ = setup
    model = _port(state)
    enc = jax_model.module.apply(jax_model.variables, jnp.asarray(x), y=jnp.asarray(y), method=JaxModule.encode)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x), torch.from_numpy(y))
        _close(got["features"], enc["features"])
        for name in ("prior", "posterior"):
            for a, b in zip(got[name], enc[name]):
                _close(a, b)
        z = np.random.default_rng(3).normal(size=(SHAPE[0], CONFIG["latent_dim"])).astype(np.float32)
        _close(model.reconstruct(got["features"], torch.from_numpy(z)),
               jax_model.module.apply(jax_model.variables, enc["features"], jnp.asarray(z),
                                      method=JaxModule.reconstruct))
        _close(model(torch.from_numpy(x)), jax_model.module.apply(jax_model.variables, jnp.asarray(x)))
    assert got["features"].shape == (SHAPE[0], CONFIG["num_filters"][0]) + SHAPE[2:]


def test_sample_with_jax_noise(setup):
    jax_model, state, x, _, _ = setup
    model = _port(state)
    key = jax.random.PRNGKey(4)
    expected = jax_model.sample_fn(jax_model.variables, jnp.asarray(x), key)
    with torch.no_grad():
        got = model.sample(torch.from_numpy(x), noise=_noise(key, SHAPE[0]))
        _close(got, expected)
        encoded = model.encode(torch.from_numpy(x))
        assert torch.equal(model.sample(torch.from_numpy(x), noise=_noise(key, SHAPE[0]), encoded=encoded), got)
        drawn = [model.sample(torch.from_numpy(x), generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert torch.equal(drawn[0], drawn[1]) and not torch.equal(drawn[0], drawn[2])


def _grads_close(got, expected):
    largest = max(float(v.abs().max()) for v in expected.values())
    assert largest > 0
    for name, g in got.items():
        e = expected[name]
        dist = float((g - e).norm())
        assert dist <= GRAD_TOL * float(e.norm()) + GRAD_ATOL_OF_MAX * largest * g.numel() ** 0.5, name


@pytest.mark.parametrize("rl_swap", [False, True])
@pytest.mark.parametrize("consensus_masking", [False, True])
def test_elbo_and_its_gradients_match_jax(setup, rl_swap, consensus_masking):
    jax_model, state, x, y, consm = setup
    jax_model = copy.copy(jax_model)
    jax_model.module = jax_model.module.clone(rl_swap=rl_swap, consensus_masking=consensus_masking)
    key = jax.random.PRNGKey(7)

    def jax_elbo(params):
        return jax_model.elbo_fn({"params": params}, jnp.asarray(x), jnp.asarray(y), key, consm=jnp.asarray(consm))

    value, grads = jax.value_and_grad(jax_elbo)(jax_model.variables["params"])
    model = _port(state, rl_swap=rl_swap, consensus_masking=consensus_masking)
    elbo = model.elbo(torch.from_numpy(x), torch.from_numpy(y), noise=_noise(key, SHAPE[0]),
                      consm=torch.from_numpy(consm))
    elbo.backward()
    elbo = elbo.detach()
    assert abs(float(elbo) - float(value)) <= VALUE_TOL * max(1.0, abs(float(value)))
    expected = probabilistic_unet_state_dict_from_jax_params(_flat(grads))
    _grads_close({n: p.grad for n, p in model.named_parameters()}, expected)
    # consensus masking changes the value only where it is on
    plain = model.elbo(torch.from_numpy(x), torch.from_numpy(y), noise=_noise(key, SHAPE[0])).detach()
    assert (float(plain) != float(elbo)) == consensus_masking


def test_converter_refuses_unknown_parameters(setup):
    jax_model, _, _, _, _ = setup
    flat = _flat(jax_model.variables["params"])
    flat["extra/kernel"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(ValueError, match="Unmapped"):
        probabilistic_unet_state_dict_from_jax_params(flat)


def test_factory_records_what_rebuilds_it():
    from torch_em_tpu_torch.trainer.serialization import deserialize_value, serialize_value

    model = ProbabilisticUNet(**CONFIG, beta=2.0, rl_swap=True, device="cpu", seed=3)
    rebuilt = deserialize_value(serialize_value(model))
    assert rebuilt.beta == 2.0 and rebuilt.rl_swap and rebuilt.init_kwargs == model.init_kwargs
    for (name, a), b in zip(model.state_dict().items(), rebuilt.state_dict().values()):
        assert torch.equal(a, b), name
    # the JAX factory's defaults, and its base of twice the last width
    default = ProbabilisticUNet(device="cpu")
    assert default.init_kwargs["num_filters"] == [32, 64, 128, 192] and default.init_kwargs["latent_dim"] == 6
    assert default.unet.base.block[4].weight.shape[0] == 384 and default.beta == 10.0
    with pytest.raises(ValueError, match="divisible"):
        default(torch.zeros(1, 1, 24, 24))


def test_losses_match_jax(setup):
    """``ProbabilisticUNetLoss`` and ``ProbabilisticUNetLossAndMetric`` on the same ELBO and the
    same prior samples (the port's sample_fn is given JAX's draws, one per split key)."""
    jax_model, state, x, y, _ = setup
    model = _port(state)
    key = jax.random.PRNGKey(9)
    n_samples = 3
    keys = jax.random.split(key, n_samples)
    variables = jax_model.variables

    def jax_elbo(inp, labels):
        return jax_model.elbo_fn(variables, inp, labels, key)

    noises = iter([_noise(k, SHAPE[0]) for k in keys])
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        def elbo(inp, labels):
            return model.elbo(inp, labels, noise=_noise(key, SHAPE[0]))

        got = loss.ProbabilisticUNetLoss()(elbo, xt, yt)
        expected = jax_loss.ProbabilisticUNetLoss()(jax_elbo, jnp.asarray(x), jnp.asarray(y))
        assert abs(float(got) - float(expected)) <= VALUE_TOL * abs(float(expected))
        scaled = loss.ProbabilisticUNetLoss(loss=lambda e: -2 * e)(elbo, xt, yt)
        assert abs(float(scaled) - 2 * float(got)) <= VALUE_TOL * abs(float(scaled))
        both = loss.ProbabilisticUNetLossAndMetric(activation="Sigmoid", prior_samples=n_samples)(
            elbo, xt, yt, sample_fn=lambda inp, generator: model.sample(inp, noise=next(noises)))
        jax_both = jax_loss.ProbabilisticUNetLossAndMetric(activation=jax.nn.sigmoid, prior_samples=n_samples)(
            jax_elbo, jnp.asarray(x), jnp.asarray(y), rng=key,
            sample_fn=lambda inp, k: jax_model.sample_fn(variables, inp, k))
        for a, b in zip(both, jax_both):
            assert abs(float(a) - float(b)) <= VALUE_TOL * max(1.0, abs(float(b)))
        no_samples = loss.ProbabilisticUNetLossAndMetric()(elbo, xt, yt)
        assert float(no_samples[0]) == float(no_samples[1]) == float(got)


# ------------------------------------------------------------- the trainer
LR, PARAM_TOL = 0.1, 1e-6


def _loader(x, y):
    return [(x, y)]


def _port_trainer(setup, tmp_path, train=None, **kwargs):
    from torch_em_tpu_torch.self_training import ProbabilisticUNetTrainer
    from torch_em_tpu_torch.trainer import OptimizerSpec

    _, state, x, y, _ = setup
    loader = train or _loader(x, y)
    return ProbabilisticUNetTrainer(
        name="punet", model=_port(state), train_loader=loader, val_loader=loader,
        loss=loss.ProbabilisticUNetLoss(), loss_and_metric=loss.ProbabilisticUNetLossAndMetric(prior_samples=2),
        optimizer=OptimizerSpec("sgd", lr=LR), clipping_value=1.0, device="cpu", mixed_precision=False,
        logger=None, save_root=str(tmp_path), **kwargs)


def test_trainer_step_matches_jax(setup, tmp_path, monkeypatch):
    """One step of each trainer from the same weights, the port's posterior noise JAX's draw: the
    loss, and the parameters after a clipped SGD step."""
    from torch_em_tpu.self_training import ProbabilisticUNetTrainer as JaxTrainer
    from torch_em_tpu.trainer import OptimizerSpec as JaxOptimizerSpec

    jax_model, state, x, y, _ = setup
    jax_trainer = JaxTrainer(
        name="punet", model=copy.copy(jax_model), train_loader=_loader(x, y), val_loader=_loader(x, y),
        loss=jax_loss.ProbabilisticUNetLoss(), loss_and_metric=jax_loss.ProbabilisticUNetLossAndMetric(),
        optimizer=JaxOptimizerSpec("sgd", lr=LR), clipping_value=1.0, device="cpu", mixed_precision=False,
        logger=None, save_root=str(tmp_path / "jax"))
    jax_trainer._initialize(1, None)
    key = jax.random.PRNGKey(11)
    variables, _, jax_value = jax_trainer._train_step(jax_trainer.variables, jax_trainer.opt_state,
                                                      jnp.asarray(x), jnp.asarray(y), key)

    trainer = _port_trainer(setup, tmp_path / "port")
    trainer._initialize(1, None)
    assert trainer.optimizer.grad_clip == 1.0
    monkeypatch.setattr(trainer.model, "draw_noise", lambda mu, generator=None: _noise(key, mu.shape[0]))
    value, pred = trainer._train_step(torch.from_numpy(x), torch.from_numpy(y))
    assert pred is None and abs(float(value) - float(jax_value)) <= VALUE_TOL * abs(float(jax_value))
    expected = probabilistic_unet_state_dict_from_jax_params(_flat(variables["params"]))
    moved = 0.0
    for name, got in trainer.model.state_dict().items():
        np.testing.assert_allclose(got.numpy(), expected[name].numpy(), rtol=0, atol=PARAM_TOL, err_msg=name)
        moved += float((got - state[name]).norm()) ** 2
    # the clip holds the gradient's global norm at 1, so the step's length is the learning rate
    assert abs(moved ** 0.5 - LR) < 1e-4


def test_trainer_fits_validates_and_resumes(setup, tmp_path):
    import torch_em_tpu_torch as port
    from torch_em_tpu_torch.self_training import ProbabilisticUNetTrainer

    _, _, x, y, _ = setup
    raw = np.random.default_rng(5).normal(size=(64, 64)).astype(np.float32)
    labels = (raw > 0.3).astype(np.float32)
    train = port.DataLoader(port.SegmentationDataset(raw, None, labels, None, patch_shape=(32, 32), n_samples=4),
                            batch_size=2)
    trainer = _port_trainer(setup, tmp_path, train=train)
    torch.manual_seed(0)
    trainer.fit(iterations=2)
    assert trainer.iteration == 2 and np.isfinite(trainer.current_metric)
    resumed = port.DefaultTrainer.from_checkpoint(trainer.checkpoint_folder, "latest", device="cpu")
    assert isinstance(resumed, ProbabilisticUNetTrainer) and resumed.clipping_value == 1.0
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], value), name
    resumed.fit(iterations=2)
    assert resumed.iteration == 4 and resumed.optimizer.grad_clip == 1.0
