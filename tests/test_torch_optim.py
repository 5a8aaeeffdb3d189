"""The port's optimizer specs and plateau scheduler against the JAX package's.

``OptimizerSpec`` builds an optax transformation in the JAX package and a
``torch.optim`` optimizer in the port; the same spec must give the same
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
    with pytest.raises(NotImplementedError, match="not ported"):
        OptimizerSpec(name)


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
