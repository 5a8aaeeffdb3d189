"""The U-Net's other norms and its side outputs in the port against the JAX package's.

``InstanceNormTrackStats``, ``GroupNorm`` and ``BatchNorm`` in a small UNet2d
and UNet3d (two levels, four features), with the JAX model's seeded
parameters and, after training-mode calls, its ``batch_stats`` carried over
by ``state_dict_from_jax_params``. Checked: the forward in training and
eval mode, the running statistics after two training-mode forwards, and the
gradients of a fixed linear function of the output; and
``return_side_outputs``, output by output. Tolerance: outputs and running
statistics atol 1e-4, gradients 1e-4 of the largest gradient element
(float32 on the CPU, sums in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from torch_em_tpu.models.unet import UNet2d as JaxUNet2d
from torch_em_tpu.models.unet import UNet3d as JaxUNet3d
from torch_em_tpu_torch.models import UNet2d, UNet3d
from torch_em_tpu_torch.models.unet import BatchNorm, GroupNorm, InstanceNormTrackStats
from torch_em_tpu_torch.utils.convert import state_dict_from_jax_params

ATOL, GRAD_RTOL = 1e-4, 1e-4
NORMS = ["InstanceNormTrackStats", "GroupNorm", "BatchNorm"]
MODELS = {"2d": (JaxUNet2d, UNet2d, (2, 2, 16, 16)), "3d": (JaxUNet3d, UNet3d, (2, 2, 8, 8, 8))}
KWARGS = dict(in_channels=2, out_channels=3, depth=2, initial_features=4)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(tree), sep="/").items()}


@functools.lru_cache(maxsize=None)
def _jax_model(dim, norm):
    return MODELS[dim][0](**KWARGS, norm=norm, seed=3)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(loc=0.5, size=shape).astype(np.float32)


def _port_model(dim, norm, variables):
    model = MODELS[dim][1](**KWARGS, norm=norm, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        _flat(variables["params"]), norm=norm, batch_stats=_flat(variables.get("batch_stats", {}))), strict=True)
    return model


def _jax_apply(jax_model, variables, x, train):
    mutable = ("batch_stats",) if train and "batch_stats" in variables else False
    out = jax.jit(jax_model.module.apply, static_argnames=("train", "mutable"))(
        variables, jnp.asarray(x), train=train, mutable=mutable)
    if mutable:
        out, state = out
        variables = {**variables, **state}
    return np.asarray(out), variables


@pytest.mark.parametrize("dim", sorted(MODELS))
@pytest.mark.parametrize("norm", NORMS)
def test_norm_forward_statistics_and_gradients(norm, dim):
    jax_model = _jax_model(dim, norm)
    shape = MODELS[dim][2]
    variables = jax.device_get(jax_model.variables)
    model = _port_model(dim, norm, variables)

    # two training-mode forwards: outputs, then the running statistics they leave
    model.train()
    for seed in (0, 1):
        x = _inputs(shape, seed)
        expected, variables = _jax_apply(jax_model, variables, x, train=True)
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)
    if norm != "GroupNorm":
        expected_state = state_dict_from_jax_params(_flat(variables["params"]), norm=norm,
                                                    batch_stats=_flat(variables["batch_stats"]))
        state = model.state_dict()
        stats = [k for k in state if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 2 * 2 * (2 * KWARGS["depth"] + 1)  # two statistics of two norms per block
        for key in stats:
            np.testing.assert_allclose(state[key].numpy(), expected_state[key].numpy(), rtol=0, atol=ATOL,
                                       err_msg=key)
        assert int(state[stats[0].replace("running_mean", "num_batches_tracked")]) == 2
        moved = state["encoder.blocks.0.block.3.running_var"]
        assert not torch.allclose(moved, torch.ones_like(moved))

    # eval mode: the running statistics normalize
    model.eval()
    x = _inputs(shape, 2)
    expected, _ = _jax_apply(jax_model, variables, x, train=False)
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), expected, rtol=0, atol=ATOL)

    # gradients of sum(w * out) in training mode, with respect to every parameter
    w = _inputs(expected.shape, 3)

    def jax_loss(params):
        mutable = ["batch_stats"] if "batch_stats" in variables else False
        out = jax_model.module.apply({**variables, "params": params}, jnp.asarray(x), train=True, mutable=mutable)
        out = out[0] if mutable else out
        return jnp.sum(out * jnp.asarray(w))

    jax_grads = jax.jit(jax.grad(jax_loss))(variables["params"])
    expected_grads = state_dict_from_jax_params(_flat(jax_grads), norm=norm,
                                                batch_stats=_flat(variables.get("batch_stats", {})))
    model.train()
    torch.sum(model(torch.from_numpy(x)) * torch.from_numpy(w)).backward()
    largest = max(float(g.abs().max()) for g in expected_grads.values() if g.is_floating_point())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expected_grads[name].numpy(), rtol=0,
                                   atol=GRAD_RTOL * largest, err_msg=name)
    assert model.encoder.blocks[0].block[0].weight.grad.abs().max() > 0


@pytest.mark.parametrize("out_channels", [3, (1, 2)])
def test_side_outputs(out_channels):
    kwargs = dict(KWARGS, out_channels=out_channels, return_side_outputs=True, final_activation="Sigmoid")
    jax_model = JaxUNet2d(**kwargs, seed=5)
    model = UNet2d(**kwargs, device="cpu")
    state = state_dict_from_jax_params(_flat(jax_model.variables["params"]))
    assert "out_conv.0.weight" in state and "out_conv.1.weight" in state
    model.load_state_dict(state, strict=True)
    x = _inputs((2, 2, 16, 16), 6)
    expected = jax_model.module.apply(jax_model.variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert isinstance(got, list) and len(got) == len(expected) == 2
    assert got[0].shape[2:] == (16, 16) and got[1].shape[2:] == (8, 8)  # full resolution first
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=ATOL)


def test_norm_modules():
    """Norm layers keep float32 parameters and return the input's dtype; GroupNorm takes at most
    32 groups; BatchNorm keeps the biased batch variance, as flax does and torch's does not."""
    assert GroupNorm(64).num_groups == 32 and GroupNorm(6).num_groups == 6
    x = torch.from_numpy(_inputs((4, 3, 5, 6), 7))
    for norm in (InstanceNormTrackStats(3), GroupNorm(3), BatchNorm(3)):
        assert norm(x.bfloat16()).dtype == torch.bfloat16 and norm.weight.dtype == torch.float32
    bn = BatchNorm(3)
    bn(x)
    biased = x.transpose(0, 1).reshape(3, -1).var(dim=1, unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), (0.9 + 0.1 * biased).numpy(), rtol=1e-6)
    reference = torch.nn.BatchNorm2d(3)
    reference(x)
    assert not torch.allclose(reference.running_var, bn.running_var)
