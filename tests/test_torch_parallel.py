"""The port's multi-device layer (``parallel/``) against the JAX package's.

The JAX functions run on a mesh of the host's CPU devices (``conftest.py``
makes 8); the port's run in 2 (one test 4) spawned processes joined by gloo
through a ``file://`` store in the test's temporary directory
(``torch_parallel_workers.py`` holds their bodies, which import nothing of
JAX). Small 2-D U-Nets (depth 2, 4 features) built by the JAX package carry
their weights into the port with ``state_dict_from_jax_params``; inputs come
from ``np.random.default_rng`` seeds; float32 on both sides.

Tolerances:
- the data-parallel step against the one-process step and against the JAX
  ``DataParallelTrainer`` on 2 devices: loss rel 1e-4, parameters (and the
  BatchNorm's running statistics) atol 1e-4 after one SGD step at lr 1e-2,
  as the JAX package's own test holds its step;
- sharded predictions (sigmoid outputs): atol 1e-4, as the prediction tests;
- the spatially sharded step's gradients: per tensor 1e-4 of the largest
  gradient element of the model (float32 sums of the two frameworks in
  another order), its loss rel 1e-5;
- the halo exchange's backward against the same sums in one process: 1e-6.
"""

import copy
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import torch_parallel_workers as workers
from torch_em_tpu.data.loader import DataLoader as JaxDataLoader
from torch_em_tpu.loss import DiceLoss as JaxDiceLoss
from torch_em_tpu.models import AnisotropicUNet as JaxAnisotropicUNet, UNet2d as JaxUNet2d, UNet3d as JaxUNet3d
from torch_em_tpu.models.base import Model as JaxModel
from torch_em_tpu.parallel import DataParallelTrainer as JaxDataParallelTrainer, get_mesh as jax_mesh
from torch_em_tpu.parallel import halo as jax_halo
from torch_em_tpu.trainer import OptimizerSpec as JaxOptimizerSpec
from torch_em_tpu.utils import prediction as jax_prediction
import torch_em_tpu_torch as port
from torch_em_tpu_torch.parallel import halo
from torch_em_tpu_torch.utils.convert import state_dict_from_jax_params

TRACKED_FACTORS = [[1, 2, 2], [1, 2, 2], [2, 2, 2], [2, 2, 2]]
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4
PRED_ATOL = 1e-4
GRAD_RTOL_OF_MAX = 1e-4


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(tree), sep="/").items()}


def _jit_initialize(model, rng=None, example=None):
    """``Model.initialize`` under jit: the JAX models' eager init takes seconds to minutes."""
    rng = jax.random.PRNGKey(model._seed) if rng is None else rng
    example = jnp.zeros(model.example_input_shape, jnp.float32) if example is None else example
    model.variables = jax.jit(lambda r, x: model.module.init(r, x, train=False))(rng, example)
    return model.variables


@functools.lru_cache(maxsize=None)
def _jax_unet(norm, out_channels, seed=123):
    with mock.patch.object(JaxModel, "initialize", _jit_initialize):
        return JaxUNet2d(in_channels=1, out_channels=out_channels, depth=2, initial_features=4,
                         final_activation="Sigmoid", norm=norm, seed=seed)


def _state(variables, norm):
    return state_dict_from_jax_params(_flat(variables["params"]), norm=norm,
                                      batch_stats=_flat(variables.get("batch_stats", {})))


def _port_state(norm, out_channels):
    return _state(_jax_unet(norm, out_channels).variables, norm)


# ------------------------------------------------------------------ the data-parallel step
DP_CASES = {"instance_norm": ("InstanceNorm", 4), "batch_norm": ("BatchNorm", 4), "ragged_batch": ("InstanceNorm", 3)}


def _dp_batch(n):
    rng = np.random.default_rng(0)
    x = rng.random((4, 1, 32, 32), dtype=np.float32)
    y = (rng.random((4, 2, 32, 32)) > 0.5).astype(np.float32)
    return x[:n], y[:n]


def _jax_dp_step(norm, x, y, tmp_path):
    """The JAX DataParallelTrainer's step over 2 devices on the whole batch."""
    loader = JaxDataLoader(workers.ArrayDataset(x, y), batch_size=len(x))
    trainer = JaxDataParallelTrainer(
        name="dp", model=copy.copy(_jax_unet(norm, 2)), train_loader=loader, val_loader=loader, loss=JaxDiceLoss(),
        metric=JaxDiceLoss(), optimizer=JaxOptimizerSpec("sgd", lr=workers.DP_LR), mixed_precision=False,
        device="cpu", logger=None, save_root=str(tmp_path / "jax"), mesh=jax_mesh(n_devices=2))
    trainer._initialize(1, None)
    variables = jax.device_get(trainer.variables)  # the step donates its inputs
    variables, _, loss, _ = trainer._train_step(trainer.variables, trainer.opt_state, trainer._to_device(x),
                                                trainer._to_device(y), jax.random.PRNGKey(7))
    return float(loss), _state(variables, norm)


def _dp_cases():
    cases = {}
    for name, (norm, n) in DP_CASES.items():
        x, y = _dp_batch(n)
        cases[name] = {"norm": norm, "x": x, "y": y, "state": _port_state(norm, 2)}
    return cases


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every case of this file's tests, run once in one pair of processes: (inputs, results, folder)."""
    folder = tmp_path_factory.mktemp("parallel")
    data = {"dp": _dp_cases(), "halo": _halo_cases(), "exchange": _exchange_case(), "spatial": _spatial_cases()}
    return data, workers.spawn(str(folder), data, ["dp_step", "halo", "exchange_grad", "spatial"]), folder


@pytest.mark.parametrize("name", list(DP_CASES))
def test_dp_step_matches_one_process_and_jax(spawned, name):
    """One step over 2 processes is the step over the whole batch: the port's own
    one-process step and the JAX DataParallelTrainer's on 2 devices. The ragged batch of 3
    pads the second process's half with the first sample, as the JAX trainer pads."""
    data, results, folder = spawned
    case, got = data["dp"][name], results["dp_step"][name]
    assert got["rank"] == 0
    one = workers.dp_trainer(workers.unet(case["norm"], 2, case["state"]), case["x"], case["y"], str(folder),
                             port.DefaultTrainer)
    one._initialize(1, None)
    one.model.train()
    x, y = torch.from_numpy(case["x"]), torch.from_numpy(case["y"])
    if len(x) % 2:
        x, y = x[[0, 1, 2, 0]], y[[0, 1, 2, 0]]
    loss_one, _ = one._train_step(x, y)
    loss_jax, state_jax = _jax_dp_step(case["norm"], case["x"], case["y"], folder / name)

    assert got["loss"] == pytest.approx(float(loss_one), rel=LOSS_RTOL)
    assert got["loss"] == pytest.approx(loss_jax, rel=LOSS_RTOL)
    state_one = one.model.state_dict()
    for key, value in got["state"].items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value.numpy(), state_one[key].numpy(), rtol=0, atol=PARAM_ATOL, err_msg=key)
        np.testing.assert_allclose(value.numpy(), state_jax[key].numpy(), rtol=0, atol=PARAM_ATOL, err_msg=key)
    # the step moved the weights, and BatchNorm's running statistics are those of the whole batch
    assert not torch.equal(got["state"]["encoder.blocks.0.block.1.weight"],
                           case["state"]["encoder.blocks.0.block.1.weight"])
    if case["norm"] == "BatchNorm":
        assert not torch.equal(got["state"]["encoder.blocks.0.block.0.running_mean"],
                               case["state"]["encoder.blocks.0.block.0.running_mean"])


# --------------------------------------------------------------------- the halo
@pytest.mark.parametrize("factors,axes", [
    (TRACKED_FACTORS, (0, 1, 2)), ([[1, 2, 2], [2, 2, 2]], (0, 1)), (None, (0,)),
])
def test_receptive_field_halo_and_downscale_match_jax(factors, axes):
    """The derived halo and downscale equal the JAX package's; the tracked CREMI model's halo
    along z is 36 planes (factors 1, 1, 2, 2: a field of 34, rounded up to the downscale 4).
    Both read the models' ``init_kwargs`` only, so the JAX models skip their weights."""
    with mock.patch.object(JaxModel, "initialize", lambda model: None):
        if factors is None:
            jax_model = JaxUNet3d(in_channels=1, out_channels=1, depth=3, initial_features=32)
            model = port.UNet3d(1, 1, depth=3, initial_features=32, device="cpu")
        else:
            jax_model = JaxAnisotropicUNet(in_channels=1, out_channels=1, scale_factors=factors, initial_features=32)
            model = port.AnisotropicUNet(1, 1, scale_factors=factors, initial_features=32, device="cpu")
    for axis in axes:
        assert halo.receptive_field_halo(model, axis) == jax_halo.receptive_field_halo(jax_model, axis)
        assert halo.total_downscale(model, axis) == jax_halo.total_downscale(jax_model, axis)
    if factors == TRACKED_FACTORS:
        assert halo.receptive_field_halo(model, 0) == 36 and halo.total_downscale(model, 0) == 4


HALO_CASES = {
    # a norm-free model with the derived halo (28 for depth 2): the sharded output equals the
    # unsharded forward away from the volume border
    "norm_free": dict(norm=None, shape=(1, 128, 32), halo=None),
    # InstanceNorm normalises each slab with its halo: equal to predict_with_halo with slab blocks
    "instance_norm": dict(norm="InstanceNorm", shape=(1, 128, 32), halo=24),
    # 125 planes do not divide the mesh: chunks of 64 padded to the mesh and downscale quantum
    "large_odd_extent": dict(norm=None, shape=(1, 125, 32), halo=None, chunk=64),
}


def _halo_cases():
    cases = {}
    for seed, (name, case) in enumerate(HALO_CASES.items()):
        volume = np.random.default_rng(10 + seed).random(case["shape"], dtype=np.float32)
        cases[name] = {**case, "volume": volume, "state": _port_state(case["norm"], 2)}
    return cases


def _exchange_case():
    """Two slabs of 20 planes along axis 2 with a halo of 6, and a weight per extended slab."""
    return {"x": np.random.default_rng(3).normal(size=(2, 3, 40, 8)).astype(np.float32), "halo": 6,
            "w": np.random.default_rng(4).normal(size=(2, 2, 3, 20 + 12, 8)).astype(np.float32)}


@pytest.mark.parametrize("name", list(HALO_CASES))
def test_halo_sharded_predict_matches_jax(spawned, name):
    data, results, _ = spawned
    case, got = data["halo"][name], results["halo"][name]
    jax_model = _jax_unet(case["norm"], 2)
    mesh = jax_mesh(n_devices=2, axis_names=("space",))
    if "chunk" in case:
        expected = jax_halo.halo_sharded_predict_large(jax_model, case["volume"], mesh, chunk=case["chunk"])
    else:
        expected = jax_halo.halo_sharded_predict(jax_model, case["volume"], mesh, halo=case["halo"])
    assert got.shape == expected.shape == (2,) + case["shape"][1:]
    np.testing.assert_allclose(got, expected, rtol=0, atol=PRED_ATOL)
    model = workers.unet(case["norm"], 2, case["state"]).eval()
    if name == "norm_free":
        h = halo.receptive_field_halo(model)
        with torch.no_grad():
            full = model(torch.from_numpy(case["volume"][None]))[0].numpy()
        np.testing.assert_allclose(got[:, h:-h], full[:, h:-h], rtol=0, atol=PRED_ATOL)
    if name == "instance_norm":
        blocked = port.predict_with_halo(case["volume"][0], model, block_shape=(64, 32), halo=(case["halo"], 0),
                                         preprocess=None)
        np.testing.assert_allclose(got, blocked, rtol=0, atol=1e-5)


def test_halo_exchange_backward_returns_gradients_to_their_source(spawned):
    """sum(w_r * extended slab_r) over both processes: the gradient of the slabs equals the same
    sums built in one process from slices and flips of the whole tensor."""
    data, results, _ = spawned
    case = data["exchange"]
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    h, s = case["halo"], case["x"].shape[2] // 2
    top, bottom = x[:, :, :s], x[:, :, s:]
    ext = [torch.cat([top[:, :, 1:h + 1].flip(2), top, bottom[:, :, :h]], dim=2),
           torch.cat([top[:, :, -h:], bottom, bottom[:, :, -h - 1:-1].flip(2)], dim=2)]
    sum((e * torch.from_numpy(case["w"][r])).sum() for r, e in enumerate(ext)).backward()
    np.testing.assert_allclose(results["exchange_grad"], x.grad.numpy(), rtol=0, atol=1e-6)


# ------------------------------------------------------------ the spatially sharded step
def _jax_spatial_grads(norm, x, y, mesh, batch_axis=None):
    model = _jax_unet(norm, 2)
    tx = JaxOptimizerSpec("sgd", lr=1.0).build()
    step, shard = jax_halo.spatial_sharded_train_step(model, JaxDiceLoss(), tx, mesh, batch_axis=batch_axis)
    before = jax.device_get(model.variables)
    variables = jax.device_put(before)
    new, _, loss = step(variables, tx.init(variables["params"]), *shard(x, y))
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), before["params"],
                                   jax.device_get(new["params"]))
    return float(loss), state_dict_from_jax_params(_flat(grads), norm=norm)


SPATIAL_CASES = {"norm_free": dict(norm=None, batch=1), "instance_norm": dict(norm="InstanceNorm", batch=1),
                 "batch2_norm_free": dict(norm=None, batch=2)}


def _spatial_inputs(batch, seed):
    rng = np.random.default_rng(seed)
    return rng.random((batch, 1, 128, 32), dtype=np.float32), (rng.random((batch, 2, 128, 32)) > 0.5).astype(
        np.float32)


def _check_grads(got, expected):
    largest = max(float(g.abs().max()) for g in expected.values())
    for key, g in expected.items():
        np.testing.assert_allclose(got[key].numpy(), g.numpy(), rtol=0, atol=GRAD_RTOL_OF_MAX * largest, err_msg=key)


def _spatial_cases():
    cases = {name: {**c, "state": _port_state(c["norm"], 2)} for name, c in SPATIAL_CASES.items()}
    for seed, case in enumerate(cases.values()):
        case["x"], case["y"] = _spatial_inputs(case["batch"], 20 + seed)
    return cases


@pytest.mark.parametrize("name", list(SPATIAL_CASES))
def test_spatial_sharded_train_step_matches_jax(spawned, name):
    """The step's loss and gradients over 2 processes against the JAX step over 2 devices
    (with InstanceNorm both normalise each slab with its halo)."""
    data, results, _ = spawned
    case = data["spatial"][name]
    loss, grads = _jax_spatial_grads(case["norm"], case["x"], case["y"], jax_mesh(n_devices=2, axis_names=("space",)))
    assert results["spatial"][name]["loss"] == pytest.approx(loss, rel=1e-5)
    _check_grads(results["spatial"][name]["grads"], grads)


# --------------------------------------------------- predict_with_halo on several devices
def test_predict_with_halo_on_two_devices_matches_jax():
    """gpu_ids naming two devices: a replica on each (both on the CPU here) takes every other
    batch; against the JAX call on two of the host's devices."""
    volume = np.random.default_rng(40).random((96, 48), dtype=np.float32)
    jax_model = _jax_unet("InstanceNorm", 2)
    model = workers.unet("InstanceNorm", 2, _port_state("InstanceNorm", 2)).eval()
    kwargs = dict(block_shape=(32, 32), halo=(8, 8), batch_size=2)
    expected = jax_prediction.predict_with_halo(volume, jax_model, devices=jax.devices()[:2], disable_tqdm=True,
                                                **kwargs)
    got = port.predict_with_halo(volume, model, gpu_ids=["cpu", "cpu"], **kwargs)
    np.testing.assert_allclose(got, np.asarray(expected), rtol=0, atol=PRED_ATOL)
    np.testing.assert_array_equal(got, port.predict_with_halo(volume, model, **kwargs))
