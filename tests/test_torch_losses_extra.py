"""The port's clDice, affinity side, combined and distance losses against the JAX package's.

The same seeded float32 inputs go through both packages: values agree within
1e-5 (of max(1, |value|) for the weighted sums that probe a skeleton's
gradient) and gradients (``torch.autograd`` against ``jax.grad``) within
1e-4. The inputs are continuous, so that no max-pooling window holds a tie.

The JAX package's affinity side loss takes ``jnp.linalg.norm`` of embedding
differences, whose gradient at a zero difference is NaN; the edge
replication of a shift makes such zeros at the border of every shifted
axis. The port's ``torch.linalg.vector_norm`` takes the subgradient 0 there,
as torch-em's ``torch.norm`` does, so its gradient must be finite
everywhere and equal the JAX gradient wherever that is finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_em_tpu.loss import affinity_side_loss as jax_side
from torch_em_tpu.loss import cldice as jax_cldice
from torch_em_tpu.loss import combined_loss as jax_combined
from torch_em_tpu.loss import dice as jax_dice
from torch_em_tpu.loss import distance_based as jax_distance
from torch_em_tpu_torch import loss
from torch_em_tpu_torch.loss import affinity_side_loss as side

VALUE_TOL, GRAD_TOL = 1e-5, 1e-4
SHAPES = {"2d": (2, 2, 20, 22), "3d": (1, 2, 6, 14, 16)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    y = (rng.random(shape) > 0.6).astype(np.float32)
    return x, y


def _torch_value_and_grad(fn, x, *rest):
    xt = torch.from_numpy(x).requires_grad_()
    value = fn(xt, *(torch.from_numpy(r) for r in rest))
    value.backward()
    return float(value.detach()), xt.grad.numpy()


def _jax_value_and_grad(fn, x, *rest):
    value, grad = jax.value_and_grad(lambda a: fn(a, *(jnp.asarray(r) for r in rest)))(jnp.asarray(x))
    return float(value), np.asarray(grad)


def _check(ours, theirs, x, *rest):
    value, grad = _torch_value_and_grad(ours, x, *rest)
    jax_value, jax_grad = _jax_value_and_grad(theirs, x, *rest)
    assert abs(value - jax_value) <= VALUE_TOL * max(1.0, abs(jax_value)), (value, jax_value)
    assert np.isfinite(grad).all() and np.abs(grad).max() > 0
    finite = np.isfinite(jax_grad)
    np.testing.assert_allclose(grad[finite], jax_grad[finite], rtol=0, atol=GRAD_TOL)
    return value, finite


@pytest.mark.parametrize("ndim", ["2d", "3d"])
@pytest.mark.parametrize("num_iter", [1, 5])
def test_soft_skeletonize(ndim, num_iter):
    x, _ = _inputs(SHAPES[ndim])
    ours, theirs = loss.SoftSkeletonize(num_iter), jax_cldice.SoftSkeletonize(num_iter)
    got = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(theirs(jnp.asarray(x))), rtol=0, atol=VALUE_TOL)
    assert got.max() > 0
    weights = np.random.default_rng(1).random(x.shape, dtype=np.float32)
    _check(lambda a, w: (ours(a) * w).sum(), lambda a, w: (theirs(a) * w).sum(), x, weights)


@pytest.mark.parametrize("ndim", ["2d", "3d"])
@pytest.mark.parametrize("exclude_background", [False, True])
def test_cldice_losses(ndim, exclude_background):
    x, y = _inputs(SHAPES[ndim])
    kwargs = dict(num_iter=3, exclude_background=exclude_background)
    _check(loss.SoftclDiceLoss(**kwargs), jax_cldice.SoftclDiceLoss(**kwargs), x, y)
    _check(loss.CombinedclDiceLoss(alpha=0.3, **kwargs), jax_cldice.CombinedclDiceLoss(alpha=0.3, **kwargs), x, y)
    _check(lambda a, b: loss.cldice_score(a, b, num_iter=2), lambda a, b: jax_cldice.cldice_score(a, b, num_iter=2),
           x, y)
    assert loss.SoftclDiceLoss(**kwargs).init_kwargs == jax_cldice.SoftclDiceLoss(**kwargs).init_kwargs
    with pytest.raises(ValueError):
        loss.SoftclDiceLoss()(torch.from_numpy(x), torch.from_numpy(y)[:, :1])


@pytest.mark.parametrize("ndim", ["2d", "3d"])
def test_shift_and_affinities(ndim):
    rng = np.random.default_rng(2)
    shape = SHAPES[ndim]
    spatial = len(shape) - 2
    emb = rng.normal(size=shape).astype(np.float32)
    seg = rng.integers(0, 4, size=(shape[0], 1) + shape[2:]).astype(np.float32)
    offsets = [[-1] + [0] * (spatial - 1), [0] * (spatial - 1) + [2], [3, -2] + [1] * (spatial - 2)]
    for off in offsets:
        np.testing.assert_array_equal(side.shift_tensor(torch.from_numpy(emb), off).numpy(),
                                      np.asarray(jax_side.shift_tensor(jnp.asarray(emb), off)))
    np.testing.assert_array_equal(side.segmentation_to_affinities(torch.from_numpy(seg), offsets).numpy(),
                                  np.asarray(jax_side.segmentation_to_affinities(jnp.asarray(seg), offsets)))
    np.testing.assert_allclose(side.embeddings_to_affinities(torch.from_numpy(emb), offsets, 1.5).numpy(),
                               np.asarray(jax_side.embeddings_to_affinities(jnp.asarray(emb), offsets, 1.5)),
                               rtol=0, atol=VALUE_TOL)


@pytest.mark.parametrize("ndim", ["2d", "3d"])
def test_affinity_side_loss(ndim, monkeypatch):
    """The port draws its offsets with numpy; it is given the offsets the JAX loss draws
    from its key, and must then compute the same loss."""
    rng = np.random.default_rng(3)
    shape = SHAPES[ndim]
    ranges = [(-2, 3)] * (len(shape) - 2)
    emb = rng.normal(size=shape).astype(np.float32)
    seg = rng.integers(0, 4, size=(shape[0], 1) + shape[2:]).astype(np.float32)
    ours, theirs = loss.AffinitySideLoss(ranges, n_samples=5, delta=2.0), jax_side.AffinitySideLoss(ranges, 5, 2.0)
    key = jax.random.PRNGKey(4)
    monkeypatch.setattr(ours, "_sample_offsets", lambda: np.asarray(theirs._sample_offsets(key)))
    _, finite = _check(ours, lambda a, b: theirs(a, b, rng=key), emb, seg)
    assert finite.mean() > 0.5  # NaN only at the borders, where a shift replicates the edge
    monkeypatch.undo()
    drawn = ours._sample_offsets()
    assert drawn.shape == (5, len(ranges)) and drawn.min() >= -2 and drawn.max() < 3
    assert ours.init_kwargs == theirs.init_kwargs


def test_combined_loss():
    x, y = _inputs(SHAPES["3d"])
    parts = [(loss.DiceLoss(), jax_dice.DiceLoss()), (loss.SoftclDiceLoss(num_iter=2), jax_cldice.SoftclDiceLoss(2))]
    for weights in (None, [0.7, 0.2]):
        ours = loss.CombinedLoss(*[p[0] for p in parts], loss_weights=weights)
        theirs = jax_combined.CombinedLoss(*[p[1] for p in parts], loss_weights=weights)
        _check(ours, theirs, x, y)
        assert ours.loss_weights == theirs.loss_weights


@pytest.mark.parametrize("mask_distances_in_bg", [False, True])
def test_distance_losses(mask_distances_in_bg):
    rng = np.random.default_rng(5)
    shape = (2, 3, 18, 20)
    x = rng.random(shape, dtype=np.float32)
    y = rng.random(shape, dtype=np.float32)
    y[:, 0] = (y[:, 0] > 0.5).astype(np.float32)
    _check(loss.DistanceLoss(mask_distances_in_bg), jax_distance.DistanceLoss(mask_distances_in_bg), x, y)
    _check(loss.DiceBasedDistanceLoss(mask_distances_in_bg), jax_distance.DiceBasedDistanceLoss(mask_distances_in_bg),
           x, y)
