"""The port's optimizer specs and plateau scheduler against the JAX package's.

``OptimizerSpec`` builds an optax transformation in the JAX package and a
``torch.optim`` optimizer in the port (torch's own, or the port's copy of
optax's rule for rmsprop, adagrad, lamb and lion); the same spec must give the same
parameters after k steps on the same parameters and gradients (seeded numpy
arrays). Tolerance: atol 1e-6 on O(1) parameters; the update formulas are
the same up to the order of float32 operations, and a step moves a
parameter by about lr.
"""

import types

import numpy as np
import optax
import pytest
import torch

from torch_em_tpu.trainer.optimizers import OptimizerSpec as JaxOptimizerSpec
from torch_em_tpu.trainer.optimizers import ReduceLROnPlateau as JaxReduceLROnPlateau
from torch_em_tpu.trainer.optimizers import get_learning_rate as jax_get_learning_rate
from torch_em_tpu_torch.trainer.optimizers import (
    OptimizerSpec, ReduceLROnPlateau, get_learning_rate,
)

ATOL = 1e-6
SHAPES = [(4, 3, 3, 3), (4,), (2, 5)]
STEPS = 5

SPECS = {
    "adamw": ("adamw", dict(lr=1e-3)),
    "adamw_tracked": ("adamw", dict(lr=1e-4)),
    "adamw_decay": ("adamw", dict(lr=1e-2, weight_decay=0.1, b1=0.8)),
    "adam": ("adam", dict(lr=1e-3, eps=1e-6)),
    "sgd": ("sgd", dict(lr=1e-2)),
    "sgd_momentum": ("sgd", dict(lr=1e-2, momentum=0.9)),
    "adamw_clip": ("adamw", dict(lr=1e-3, grad_clip=0.5)),
    # optax's own rules, which torch's optimizers of these names do not follow
    "rmsprop": ("rmsprop", dict(lr=1e-3)),
    "rmsprop_centered_momentum": ("rmsprop", dict(lr=1e-3, centered=True, momentum=0.9)),
    "rmsprop_bias_correction": ("rmsprop", dict(lr=1e-3, decay=0.8, bias_correction=True)),
    "rmsprop_nesterov_eps_outside": ("rmsprop", dict(lr=1e-3, momentum=0.5, nesterov=True, eps_in_sqrt=False,
                                                     initial_scale=1.0)),
    "adagrad": ("adagrad", dict(lr=1e-2)),
    "adagrad_zero_start": ("adagrad", dict(lr=1e-2, initial_accumulator_value=0.0, eps=1e-5)),
    "lamb": ("lamb", dict(lr=1e-3)),
    "lamb_decay": ("lamb", dict(lr=1e-3, weight_decay=0.1, b1=0.8)),
    "lion": ("lion", dict(lr=1e-3)),
    "lion_clip": ("lion", dict(lr=1e-4, b2=0.9, weight_decay=0.1, grad_clip=0.5)),
}


def _params_and_grads(seed):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES] for _ in range(STEPS)]
    return params, grads


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_steps_match_optax(spec):
    name, kwargs = SPECS[spec]
    params, grads = _params_and_grads(0)

    tx = JaxOptimizerSpec(name, **kwargs).build()
    jax_params = [np.asarray(p) for p in params]
    state = tx.init(jax_params)
    for g in grads:
        updates, state = tx.update(g, state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)

    torch_params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    spec_obj = OptimizerSpec(name, **kwargs)
    optimizer = spec_obj.build(torch_params)
    for g in grads:
        for p, gi in zip(torch_params, g):
            p.grad = torch.from_numpy(gi.copy())
        spec_obj.clip_gradients(torch_params)
        optimizer.step()

    for got, expected in zip(torch_params, jax_params):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(expected), rtol=0, atol=ATOL)


def test_adamw_takes_optax_defaults():
    optimizer = OptimizerSpec("adamw", lr=1e-4).build([torch.nn.Parameter(torch.zeros(2))])
    group = optimizer.param_groups[0]
    assert isinstance(optimizer, torch.optim.AdamW)
    assert group["weight_decay"] == 1e-4 and group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8


@pytest.mark.parametrize("name", ["rmsprop", "lamb"])
def test_unported_optimizers_raise(name):
    """These raised NotImplementedError until they were ported; now they build the port's own
    optimizer with optax's defaults (their steps: ``test_steps_match_optax``), and an unknown
    name raises."""
    optimizer = OptimizerSpec(name, lr=1e-3).build([torch.nn.Parameter(torch.zeros(2))])
    assert type(optimizer).__name__ == {"rmsprop": "OptaxRMSProp", "lamb": "OptaxLamb"}[name]
    assert optimizer.param_groups[0]["eps"] == {"rmsprop": 1e-8, "lamb": 1e-6}[name]
    with pytest.raises(ValueError, match="Unknown optimizer"):
        OptimizerSpec(name + "x")


def test_ported_optimizers_resume_from_state_dict():
    """An optimizer rebuilt from its ``state_dict`` (as a checkpoint resume does) takes the same steps."""
    params, grads = _params_and_grads(1)
    runs = []
    for split in (None, 2):
        torch_params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
        optimizer = OptimizerSpec("lamb", lr=1e-3, weight_decay=0.1).build(torch_params)
        for k, g in enumerate(grads):
            if k == split:
                state = optimizer.state_dict()
                optimizer = OptimizerSpec("lamb", lr=1e-3, weight_decay=0.1).build(torch_params)
                optimizer.load_state_dict(state)
            for p, gi in zip(torch_params, g):
                p.grad = torch.from_numpy(gi.copy())
            optimizer.step()
        runs.append([p.detach().clone() for p in torch_params])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


SCHEDULES = {
    "rel": (dict(factor=0.5, patience=2), [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8]),
    "abs_min_lr": (dict(factor=0.1, patience=1, threshold=0.05, threshold_mode="abs", min_lr=2e-6),
                   [1.0, 0.98, 0.97, 0.9, 0.88, 0.87, 0.86, 0.5, 0.49, 0.48, 0.47, 0.46]),
    "max": (dict(mode="max", factor=0.5, patience=0), [0.1, 0.2, 0.2, 0.3, 0.1, 0.1]),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_plateau_learning_rates_match(name):
    kwargs, metrics = SCHEDULES[name]
    lr = 1e-4
    tx = JaxOptimizerSpec("adamw", lr=lr).build()
    jax_trainer = types.SimpleNamespace(opt_state=tx.init([np.zeros(2, np.float32)]))
    jax_sched = JaxReduceLROnPlateau(**kwargs).attach(jax_trainer)

    optimizer = OptimizerSpec("adamw", lr=lr).build([torch.nn.Parameter(torch.zeros(2))])
    sched = ReduceLROnPlateau(**kwargs).attach(types.SimpleNamespace(torch_optimizer=optimizer))

    expected, got = [], []
    for metric in metrics:
        jax_sched.step(metric)
        sched.step(metric)
        expected.append(jax_get_learning_rate(jax_trainer.opt_state))
        got.append(get_learning_rate(optimizer))
    np.testing.assert_allclose(got, expected, rtol=1e-6)
    assert min(got) < lr  # each schedule reduces at least once
    assert sched.state_dict() == jax_sched.state_dict()
