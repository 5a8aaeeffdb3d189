"""The training slice as a whole: the port's trainer against the JAX package's.

A small AnisotropicUNet (two levels, four features) starts from the JAX
model's seeded weights, carried over with ``state_dict_from_jax_params``.
Both sides train in float32 on the CPU (``mixed_precision=False``, no
logger) through ``default_segmentation_trainer`` over a ``SegmentationDataset``
of the same seeded numpy volume, whose target is a threshold of the smoothed
raw data. ``np.random.seed`` before each run makes both datasets draw the
same crops.

Gradients agree only where the loss has one: a ReLU input that lies within
the two frameworks' float32 rounding of zero may fall on different sides of
the kink, and then the two sides hold different one-sided gradients (the
same trap as the max pool's ties, which the JAX package routes to one
operand per axis and torch to one argmax). Inputs with no positive ties
and no such flip are the case checked here.

Tolerances:
- one-step loss: rtol 1e-5 (float32 sums in another order);
- one-step gradients: per tensor, ``1e-3 * max|g| + 1e-5 * G`` with G the
  largest gradient element of the model. The second term covers the
  upsamplers' biases, whose true gradient is zero (the next norm removes
  any per-channel constant), so both sides hold rounding noise there;
- after ``fit(iterations=3)`` with AdamW at lr 1e-4: the validation metric to
  rtol 1e-5, and every parameter but the upsamplers' biases to
  ``0.1 * lr * 3`` (a tenth of an Adam step per step; a wrong gradient moves
  a parameter by up to a whole step). AdamW normalises each gradient
  element, so the upsamplers' biases, whose gradients are rounding noise,
  move by up to lr per step in a direction that noise decides on either
  side; the test shows instead that they do not change the output.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict
from scipy import ndimage

import torch_em_tpu as te
from torch_em_tpu.data.loader import DataLoader as JaxDataLoader
from torch_em_tpu.data.segmentation_dataset import SegmentationDataset as JaxSegmentationDataset
from torch_em_tpu.loss import DiceLoss as JaxDiceLoss
from torch_em_tpu.models.unet import AnisotropicUNet as JaxAnisotropicUNet
import torch_em_tpu_torch as port
from torch_em_tpu_torch.utils.convert import state_dict_from_jax_params

MODEL = dict(in_channels=1, out_channels=1, scale_factors=[[1, 2, 2], [2, 2, 2]],
             initial_features=4, final_activation="Sigmoid", anisotropic_kernel=True)
PATCH = (8, 32, 32)
LR = 1e-4
ITERATIONS = 3
DATA_SEED = 21
UPSAMPLER_BIASES = ("decoder.samplers.0.conv.bias", "decoder.samplers.1.conv.bias")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    raw = rng.normal(size=(16, 64, 64)).astype(np.float32)
    labels = (ndimage.gaussian_filter(raw, 2) > 0).astype(np.float32)
    jax_model = JaxAnisotropicUNet(**MODEL, seed=0)
    params = {k: np.asarray(v) for k, v in flatten_dict(jax_model.variables["params"], sep="/").items()}
    return raw, labels, jax_model, state_dict_from_jax_params(params)


def _port_model(state):
    model = port.AnisotropicUNet(**MODEL, device="cpu")
    model.load_state_dict(state, strict=True)
    return model


def _datasets(ds_cls, raw, labels):
    return (ds_cls(raw, None, labels, None, patch_shape=PATCH, n_samples=ITERATIONS),
            ds_cls(raw, None, labels, None, patch_shape=PATCH, n_samples=2))


def test_one_step_loss_and_gradients_match(setup):
    raw, labels, jax_model, state = setup
    train_ds, _ = _datasets(JaxSegmentationDataset, raw, labels)
    np.random.seed(DATA_SEED)
    x, y = (a[None] for a in train_ds[0])  # the first batch of the fit below

    def loss_fn(params):
        pred = jax_model.module.apply({"params": params}, jnp.asarray(x), train=True)
        return JaxDiceLoss()(pred, jnp.asarray(y))

    loss_jax, grads_jax = jax.jit(jax.value_and_grad(loss_fn))(jax_model.variables["params"])
    grads_jax = state_dict_from_jax_params(
        {k: np.asarray(v) for k, v in flatten_dict(grads_jax, sep="/").items()})

    model = _port_model(state)
    loss = port.DiceLoss()(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()

    np.testing.assert_allclose(float(loss), float(loss_jax), rtol=1e-5)
    largest = max(float(g.abs().max()) for g in grads_jax.values())
    for name, p in model.named_parameters():
        expected = grads_jax[name].numpy()
        atol = 1e-3 * np.abs(expected).max() + 1e-5 * largest
        np.testing.assert_allclose(p.grad.numpy(), expected, rtol=0, atol=atol, err_msg=name)


def test_fit_matches_jax_trainer(setup, tmp_path):
    raw, labels, jax_model, state = setup

    jax_model = copy.copy(jax_model)  # the trainer replaces the copy's variables
    train_ds, val_ds = _datasets(JaxSegmentationDataset, raw, labels)
    np.random.seed(DATA_SEED)
    jax_trainer = te.default_segmentation_trainer(
        "parity", jax_model, JaxDataLoader(train_ds), JaxDataLoader(val_ds), learning_rate=LR,
        mixed_precision=False, device="cpu", logger=None, save_root=str(tmp_path / "jax"))
    jax_trainer.fit(iterations=ITERATIONS)
    expected = state_dict_from_jax_params(
        {k: np.asarray(v) for k, v in
         flatten_dict(jax.device_get(jax_trainer.variables["params"]), sep="/").items()})

    model = _port_model(state)
    train_ds, val_ds = _datasets(port.SegmentationDataset, raw, labels)
    np.random.seed(DATA_SEED)
    trainer = port.default_segmentation_trainer(
        "parity", model, port.DataLoader(train_ds), port.DataLoader(val_ds), learning_rate=LR,
        mixed_precision=False, device="cpu", logger=None, save_root=str(tmp_path / "port"))
    trainer.fit(iterations=ITERATIONS)

    assert trainer.iteration == jax_trainer.iteration == ITERATIONS
    np.testing.assert_allclose(trainer.current_metric, jax_trainer.current_metric, rtol=1e-5)
    got = model.state_dict()
    for name in got:
        if name in UPSAMPLER_BIASES:
            continue
        np.testing.assert_allclose(got[name].numpy(), expected[name].numpy(), rtol=0,
                                   atol=0.1 * LR * ITERATIONS, err_msg=name)

    # the upsamplers' biases do not reach the output: the next norm removes them
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 1) + PATCH).astype(np.float32))
    with torch.no_grad():
        before = model(x)
        for name in UPSAMPLER_BIASES:
            got[name].add_(0.5)
        after = model(x)
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=0, atol=1e-5)
