"""The port's Dice losses and loss wrappers against the JAX package's.

Inputs are made with ``np.random.default_rng(seed)`` and go through both
sides as numpy arrays (channel-first on both). Values and gradients with
respect to the prediction are compared in float32 with rtol 1e-5 and
atol 1e-6: the sums run in another order, the values are O(1) and the
gradients O(1 / number of elements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_em_tpu.loss import dice as jax_dice
from torch_em_tpu.loss import wrapper as jax_wrapper
from torch_em_tpu_torch.loss import dice, wrapper

RTOL, ATOL = 1e-5, 1e-6
SHAPE = (2, 3, 8, 8)


def _pred_target(seed, shape=SHAPE, logits=False):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=shape) if logits else rng.uniform(0.01, 0.99, size=shape)
    target = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    return pred.astype(np.float32), target


def _value_and_grad_jax(fn, pred, target):
    value, grad = jax.value_and_grad(lambda p: fn(p, jnp.asarray(target)))(jnp.asarray(pred))
    return np.asarray(value), np.asarray(grad)


def _value_and_grad_torch(fn, pred, target):
    p = torch.from_numpy(pred).requires_grad_()
    value = fn(p, torch.from_numpy(target))
    value.sum().backward()
    return value.detach().numpy(), p.grad.numpy()


def _compare(jax_fn, torch_fn, pred, target):
    v_jax, g_jax = _value_and_grad_jax(lambda p, t: jnp.sum(jax_fn(p, t)), pred, target)
    v_torch, g_torch = _value_and_grad_torch(torch_fn, pred, target)
    np.testing.assert_allclose(v_torch.sum(), v_jax, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g_torch, g_jax, rtol=RTOL, atol=ATOL)


def test_flatten_samples():
    x = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    np.testing.assert_array_equal(dice.flatten_samples(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_dice.flatten_samples(jnp.asarray(x))))


@pytest.mark.parametrize("channelwise", [True, False])
@pytest.mark.parametrize("reduce_channel", ["sum", "mean", "max", "min", None])
@pytest.mark.parametrize("invert", [True, False])
def test_dice_score(channelwise, reduce_channel, invert):
    pred, target = _pred_target(0)
    kwargs = dict(invert=invert, channelwise=channelwise, reduce_channel=reduce_channel)
    if channelwise and reduce_channel is None:
        got = dice.dice_score(torch.from_numpy(pred), torch.from_numpy(target), **kwargs)
        assert got.shape == (SHAPE[1],)
    _compare(lambda p, t: jax_dice.dice_score(p, t, **kwargs),
             lambda p, t: dice.dice_score(p, t, **kwargs), pred, target)


LOSSES = {
    "DiceLoss": (jax_dice.DiceLoss, dice.DiceLoss, dict(), False),
    "DiceLoss_mean": (jax_dice.DiceLoss, dice.DiceLoss, dict(reduce_channel="mean"), False),
    "DiceLoss_global": (jax_dice.DiceLoss, dice.DiceLoss, dict(channelwise=False), False),
    "DiceLossWithLogits": (jax_dice.DiceLossWithLogits, dice.DiceLossWithLogits, dict(), True),
    "BCEDiceLoss": (jax_dice.BCEDiceLoss, dice.BCEDiceLoss, dict(alpha=0.7, beta=1.3), False),
    "BCEDiceLossWithLogits": (jax_dice.BCEDiceLossWithLogits, dice.BCEDiceLossWithLogits,
                              dict(alpha=0.5), True),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_gradient(name):
    jax_cls, torch_cls, kwargs, logits = LOSSES[name]
    pred, target = _pred_target(1, logits=logits)
    torch_loss = torch_cls(**kwargs)
    assert torch_loss.init_kwargs == jax_cls(**kwargs).init_kwargs
    _compare(jax_cls(**kwargs), torch_loss, pred, target)


def test_dice_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="same shape"):
        dice.dice_score(torch.zeros(1, 1, 4), torch.zeros(1, 2, 4))
    with pytest.raises(ValueError, match="channel reduction"):
        dice.DiceLoss(reduce_channel="median")


def _masked_target(seed, ignore_label=None):
    rng = np.random.default_rng(seed)
    pred, target = _pred_target(seed)
    if ignore_label is not None:
        target = np.where(rng.uniform(size=SHAPE) < 0.2, ignore_label, target).astype(np.float32)
    return pred, target


WRAPPERS = {
    "ApplyAndRemoveMask": lambda m: m.ApplyAndRemoveMask(),
    "ApplyAndRemoveMask_multiply": lambda m: m.ApplyAndRemoveMask(masking_method="multiply"),
    "MaskIgnoreLabel": lambda m: m.MaskIgnoreLabel(ignore_label=-1),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_loss_wrapper_with_mask(name):
    if name.startswith("ApplyAndRemoveMask"):
        pred, target = _pred_target(2)
        mask = (np.random.default_rng(3).uniform(size=SHAPE) > 0.3).astype(np.float32)
        target = np.concatenate([target, mask], axis=1)
    else:
        pred, target = _masked_target(4, ignore_label=-1)
    jax_loss = jax_wrapper.LossWrapper(jax_dice.DiceLoss(), WRAPPERS[name](jax_wrapper))
    torch_loss = wrapper.LossWrapper(dice.DiceLoss(), WRAPPERS[name](wrapper))
    _compare(jax_loss, torch_loss, pred, target)


def test_loss_wrapper_over_lists():
    """A list of predictions and targets sums the per-pair losses."""
    (p0, t0), (p1, t1) = _masked_target(5, -1), _masked_target(6, -1)
    transform_jax, transform = jax_wrapper.MaskIgnoreLabel(), wrapper.MaskIgnoreLabel()
    expected = jax_wrapper.LossWrapper(jax_dice.DiceLoss(), transform_jax)(
        [jnp.asarray(p0), jnp.asarray(p1)], [jnp.asarray(t0), jnp.asarray(t1)])
    got = wrapper.LossWrapper(dice.DiceLoss(), transform)(
        [torch.from_numpy(p0), torch.from_numpy(p1)], [torch.from_numpy(t0), torch.from_numpy(t1)])
    np.testing.assert_allclose(float(got), float(expected), rtol=RTOL, atol=ATOL)


def test_apply_mask_multiplies():
    pred, target = _pred_target(7)
    mask = np.random.default_rng(8).uniform(size=SHAPE) > 0.5
    p, t = wrapper.ApplyMask()(torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(mask))
    pj, tj = jax_wrapper.ApplyMask()(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(t.numpy(), np.asarray(tj))
    with pytest.raises(ValueError, match="not available"):
        wrapper.ApplyMask(masking_method="drop")
    with pytest.raises(ValueError, match="callable"):
        wrapper.LossWrapper(dice.DiceLoss(), transform=None)
