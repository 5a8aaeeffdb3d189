"""The SPOCO path of the port against the JAX package's: the contrastive terms and
losses, the SPOCO losses, and ``SPOCOTrainer``.

Both sides take the same seeded numpy embeddings and targets on the CPU in
float32. The targets hold an id at or beyond ``max_instances`` (which JAX's
``segment_sum`` leaves out of the means and its gather clamps) and
single-pixel instances (a zero distance to the mean, where an unguarded
norm has a NaN gradient). Random draws cannot be shared between ``jax.random``
and ``torch``: the port's losses are given the anchors and offsets that the
JAX losses draw from their keys.

Tolerances: values 1e-5 relative (float32 sums in another order), gradients
1e-4 of the largest gradient element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_em_tpu.loss import contrastive_impl as jax_impl
from torch_em_tpu.loss import spoco_loss as jax_spoco
from torch_em_tpu.loss.contrastive import ContrastiveLoss as JaxContrastiveLoss
from torch_em_tpu_torch import loss
from torch_em_tpu_torch.loss import contrastive_impl as impl

VALUE_TOL, GRAD_TOL = 1e-5, 1e-4
MAX_INSTANCES = 8


def _embedding_target(n=2, e=4, shape=(12, 14), seed=0):
    """Embeddings and ids 0-4 with a single-pixel instance (5) and an id past the cap (11)."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, e) + shape).astype(np.float32)
    target = rng.integers(0, 5, size=(n, 1) + shape).astype(np.int64)
    target[:, 0, :4, :5] = 0  # enough background for the consistency term
    target[0, 0, 6, 7] = 5
    target[1, 0, 2, 9] = 5
    target[0, 0, 8:10, 10:12] = 11
    return emb, target


def _check(ours, theirs, x, *rest, jax_nan=False):
    """Value and gradient with respect to ``x`` of ``ours`` (torch) and ``theirs`` (JAX). With
    ``jax_nan`` the gradients are compared where JAX's is finite: the JAX package's
    ``AffinitySideLoss`` has NaN gradients where a shifted embedding equals its source (edge
    replication makes such zeros at the borders), where the port takes torch-em's subgradient 0
    (ROADMAP Queue 3 item 8)."""
    xt = torch.from_numpy(x).requires_grad_()
    value = ours(xt, *(torch.from_numpy(r) for r in rest))
    value.backward()
    value = value.detach()
    jax_value, jax_grad = jax.value_and_grad(lambda a: theirs(a, *(jnp.asarray(r) for r in rest)))(jnp.asarray(x))
    jax_grad = np.asarray(jax_grad)
    assert abs(float(value) - float(jax_value)) <= VALUE_TOL * max(1.0, abs(float(jax_value))), \
        (float(value), float(jax_value))
    grad = xt.grad.numpy()
    finite = np.isfinite(jax_grad)
    assert np.isfinite(grad).all() and (jax_nan or finite.all()) and finite.mean() > 0.5
    largest = np.abs(jax_grad[finite]).max()
    assert largest > 0
    np.testing.assert_allclose(grad[finite], jax_grad[finite], rtol=0, atol=GRAD_TOL * largest)
    return float(value)


def test_gather_index_matches_jax_indexing():
    target = np.array([0, 3, 7, 8, 11, -1, -9])
    expected = np.asarray(jnp.arange(MAX_INSTANCES)[jnp.asarray(target)])
    np.testing.assert_array_equal(impl.gather_index(torch.from_numpy(target), MAX_INSTANCES).numpy(), expected)


def test_cluster_means_leave_out_ids_past_the_cap():
    emb, target = _embedding_target()
    means, counts = impl.compute_cluster_means(torch.from_numpy(emb[0]), torch.from_numpy(target[0, 0]),
                                               MAX_INSTANCES)
    jax_means, jax_counts = jax_impl.compute_cluster_means(jnp.asarray(emb[0]), jnp.asarray(target[0, 0]),
                                                           MAX_INSTANCES)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jax_counts))
    np.testing.assert_allclose(means.numpy(), np.asarray(jax_means), rtol=VALUE_TOL, atol=1e-6)
    assert counts.sum() == target[0, 0].size - 4 and counts[5] == 1  # the four pixels of id 11 are out


def _term(module, term, emb, target, ignore_zero):
    """One term of the contrastive loss, by ``module`` (the port's ``impl`` or the JAX package's)."""
    means, counts = module.compute_cluster_means(emb, target, MAX_INSTANCES)
    if term == "variance":
        return module.compute_variance_term(means, emb, target, counts, 0.75, ignore_zero)
    if term == "distance":
        return module.compute_distance_term(means, counts, 2.0, ignore_zero)
    if term == "regularizer":
        return module.compute_regularizer_term(means, counts)
    return module.compute_unlabeled_push(means, emb, target, counts, 2.0)


TERMS = ["variance", "distance", "regularizer", "unlabeled_push"]


@pytest.mark.parametrize("ignore_zero", [False, True])
@pytest.mark.parametrize("term", TERMS)
def test_contrastive_terms(term, ignore_zero):
    emb, target = _embedding_target()
    # embeddings pulled together, so that every hinge is active somewhere
    _check(lambda e, t: _term(impl, term, e[0], t[0, 0], ignore_zero),
           lambda e, t: _term(jax_impl, term, e[0], t[0, 0], ignore_zero), 0.4 * emb, target)


@pytest.mark.parametrize("scale", [0.4, 1.0])
def test_contrastive_loss(scale):
    emb, target = _embedding_target()
    kwargs = dict(delta_var=0.75, delta_dist=2.0, max_instances=MAX_INSTANCES)
    ours, theirs = loss.ContrastiveLoss(**kwargs), JaxContrastiveLoss(**kwargs)
    assert _check(ours, theirs, scale * emb, target) > 0
    assert ours.init_kwargs == theirs.init_kwargs
    assert loss.contrastive.check_consecutive([0, 1, 2]) and not loss.contrastive.check_consecutive([0, 2])


def test_single_pixel_instances_have_finite_gradients():
    """As ``tests/test_embedding_losses.py::TestNanRobustness``: a single-pixel instance puts an
    embedding exactly on its mean."""
    target = np.zeros((1, 1, 16, 16), dtype=np.int64)
    target[0, 0, 3, 3] = 1
    target[0, 0, 8:12, 8:12] = 2
    pred = np.random.RandomState(0).rand(1, 4, 16, 16).astype(np.float32)
    kwargs = dict(delta_var=0.75, delta_dist=2.0, max_instances=MAX_INSTANCES)
    _check(loss.ContrastiveLoss(**kwargs), JaxContrastiveLoss(**kwargs), pred, target)
    spoco, jax_loss = loss.SPOCOLoss(**kwargs, max_anchors=3), jax_spoco.SPOCOLoss(**kwargs, max_anchors=3)
    key = jax.random.PRNGKey(0)
    anchors = [torch.from_numpy(a.copy()) for a in _jax_anchors(jax_loss, key, target)]
    _check(lambda p, t: spoco((p, p), t, anchors=anchors), lambda p, t: jax_loss((p, p), t, rng=key), pred, target)


def _jax_anchors(jax_loss, key, target):
    """The anchors ``jax_spoco.SPOCOLoss.__call__`` draws from ``key``, one array per sample."""
    _, rng_cons = jax.random.split(key)
    rngs = jax.random.split(rng_cons, target.shape[0])
    out = []
    for b in range(target.shape[0]):
        flat_mask = jnp.asarray(target[b, 0] == 0).reshape(-1)
        logits = jnp.where(flat_mask, 0.0, -1e9)
        out.append(np.asarray(jax.random.categorical(rngs[b], logits, shape=(jax_loss.max_anchors,))))
    return out


def _jax_offsets(key, n_samples, aff_loss, split_first):
    """The offsets each sample's ``AffinitySideLoss`` draws inside the JAX contrastive loss."""
    if split_first:  # SPOCOLoss hands the first half of its key to the contrastive part
        key, _ = jax.random.split(key)
    return [np.asarray(aff_loss._sample_offsets(k)) for k in jax.random.split(key, n_samples)]


EXTENDED = {
    "dice": dict(aux_loss="dice"),
    "dice_push": dict(aux_loss="dice", unlabeled_push_weight=1.0),
    "affinity": dict(aux_loss="affinity", offset_ranges=[(-3, 3), (-3, 3)], n_samples=4),
    "dice_aff": dict(aux_loss="dice_aff", offset_ranges=[(-3, 3), (-3, 3)], n_samples=4, aff_weight=0.5),
}


@pytest.mark.parametrize("config", sorted(EXTENDED))
def test_extended_contrastive_loss(config, monkeypatch):
    emb, target = _embedding_target(seed=1)
    kwargs = dict(delta_var=0.75, delta_dist=2.0, max_instances=MAX_INSTANCES, **EXTENDED[config])
    ours, theirs = loss.ExtendedContrastiveLoss(**kwargs), jax_spoco.ExtendedContrastiveLoss(**kwargs)
    key = jax.random.PRNGKey(5)
    if ours.aff_loss is not None:
        offsets = _jax_offsets(key, len(emb), theirs.aff_loss, split_first=False)
        draws = iter(offsets)
        monkeypatch.setattr(ours.aff_loss, "_sample_offsets", lambda: next(draws))
    _check(ours, lambda e, t: theirs(e, t, rng=key), 0.5 * emb, target, jax_nan=ours.aff_loss is not None)
    assert ours.init_kwargs == theirs.init_kwargs


@pytest.mark.parametrize("config", ["default", "push_affinity"])
def test_spoco_loss(config, monkeypatch):
    emb, target = _embedding_target(seed=2)
    emb_k = np.random.default_rng(9).normal(size=emb.shape).astype(np.float32)
    kwargs = dict(delta_var=0.75, delta_dist=2.0, max_instances=MAX_INSTANCES, max_anchors=5)
    if config == "push_affinity":
        kwargs.update(unlabeled_push_weight=1.0, aux_loss="dice_aff", offset_ranges=[(1, 3), (-2, 3)], n_samples=3)
    ours, theirs = loss.SPOCOLoss(**kwargs), jax_spoco.SPOCOLoss(**kwargs)
    key = jax.random.PRNGKey(11)
    anchors = [torch.from_numpy(a.copy()) for a in _jax_anchors(theirs, key, target)]
    if ours.aff_loss is not None:
        draws = iter(_jax_offsets(key, len(emb), theirs.aff_loss, split_first=True))
        monkeypatch.setattr(ours.aff_loss, "_sample_offsets", lambda: next(draws))
    ek = torch.from_numpy(emb_k)
    value = _check(lambda e, t: ours((e, ek), t, anchors=anchors),
                   lambda e, t: theirs((e, jnp.asarray(emb_k)), t, rng=key), 0.5 * emb, target,
                   jax_nan=ours.aff_loss is not None)
    # the consistency term is part of it
    mask = torch.from_numpy(target[0, 0] == 0)
    assert value > 0 and float(ours.emb_consistency(torch.from_numpy(emb[0]), ek[0], mask, anchors[0])) > 0
    assert ours.init_kwargs == theirs.init_kwargs and ours.needs_rng


def test_spoco_loss_draws_anchors_from_the_unlabeled_pixels():
    _, target = _embedding_target()
    spoco = loss.SPOCOLoss(0.75, 2.0, max_anchors=50)
    mask = torch.from_numpy(target[0, 0] == 0)
    first = spoco.draw_anchors(mask, torch.Generator().manual_seed(0))
    again = spoco.draw_anchors(mask, torch.Generator().manual_seed(0))
    assert torch.equal(first, again) and first.shape == (50,)
    assert bool(mask.reshape(-1)[first].all())
    empty = spoco.draw_anchors(torch.zeros_like(mask), torch.Generator().manual_seed(0))
    assert empty.shape == (50,) and int(empty.max()) < mask.numel()


def test_spoco_consistency_loss():
    emb, _ = _embedding_target(seed=3)
    emb_k = np.random.default_rng(4).normal(size=emb.shape).astype(np.float32)
    kwargs = dict(delta_var=0.75, pmaps_threshold=0.9, max_anchors=6)
    ours, theirs = loss.SPOCOConsistencyLoss(**kwargs), jax_spoco.SPOCOConsistencyLoss(**kwargs)
    key = jax.random.PRNGKey(2)
    n_pixels = int(np.prod(emb.shape[2:]))
    anchors = [torch.from_numpy(np.array(jax.random.randint(k, (6,), 0, n_pixels)))
               for k in jax.random.split(key, len(emb))]
    ek = torch.from_numpy(emb_k)
    _check(lambda e: ours(e, ek, anchors=anchors), lambda e: theirs(e, jnp.asarray(emb_k), rng=key), emb)
    drawn = ours.draw_anchors(torch.from_numpy(emb[0]), torch.Generator().manual_seed(1))
    assert drawn.shape == (6,) and int(drawn.max()) < n_pixels
    assert ours.init_kwargs == theirs.init_kwargs


def test_gaussian_kernel_and_stable_anchor():
    ours, theirs = loss.GaussianKernel(0.75, 0.9), jax_spoco.GaussianKernel(0.75, 0.9)
    d = np.linspace(0, 3, 7, dtype=np.float32)
    np.testing.assert_allclose(ours(torch.from_numpy(d)).numpy(), np.asarray(theirs(jnp.asarray(d))), rtol=1e-6)
    assert float(ours(torch.tensor(0.75))) == pytest.approx(0.9)
    mean = torch.ones(3)
    assert loss.spoco_loss.select_stable_anchor(None, mean, None, 0.75) is mean


def test_embedding_losses_export():
    assert loss.EMBEDDING_LOSSES == (loss.ContrastiveLoss, loss.ExtendedContrastiveLoss, loss.SPOCOLoss)


# ---------------------------------------------------------------- SPOCOTrainer
MODEL = dict(in_channels=1, out_channels=4, depth=2, initial_features=4)
PATCH = (32, 32)
LR, MOMENTUM, ITERATIONS, DATA_SEED = 1e-4, 0.5, 3, 7
LOSS = dict(delta_var=0.75, delta_dist=2.0, max_instances=16, max_anchors=5)
UPSAMPLER_BIASES = ("decoder.samplers.0.conv.bias", "decoder.samplers.1.conv.bias")


@pytest.fixture(scope="module")
def spoco_setup():
    from flax.traverse_util import flatten_dict
    from scipy import ndimage

    from torch_em_tpu.models.unet import UNet2d as JaxUNet2d
    from torch_em_tpu_torch.utils.convert import state_dict_from_jax_params

    rng = np.random.default_rng(0)
    labels = np.zeros((48, 48), dtype=np.float32)
    for k, (y, x, h, w) in enumerate([(2, 3, 10, 12), (20, 5, 14, 9), (8, 25, 12, 15), (30, 28, 13, 14)], 1):
        labels[y:y + h, x:x + w] = k
    raw = (ndimage.gaussian_filter(labels > 0, 1.0) + 0.2 * rng.normal(size=labels.shape)).astype(np.float32)
    jax_model = JaxUNet2d(**MODEL, seed=0)
    params = {k: np.asarray(v) for k, v in flatten_dict(jax_model.variables["params"], sep="/").items()}
    return raw, labels, jax_model, state_dict_from_jax_params(params)


def _state(variables):
    from flax.traverse_util import flatten_dict

    from torch_em_tpu_torch.utils.convert import state_dict_from_jax_params

    return state_dict_from_jax_params(
        {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(variables["params"]), sep="/").items()})


def _port_trainer(setup, tmp_path, name="spoco", iterations=ITERATIONS, **kwargs):
    import torch_em_tpu_torch as port
    from torch_em_tpu_torch.trainer import SPOCOTrainer

    raw, labels, _, state = setup
    model = port.UNet2d(**MODEL, device="cpu")
    model.load_state_dict(state, strict=True)
    train = port.SegmentationDataset(raw, None, labels, None, patch_shape=PATCH, n_samples=iterations)
    val = port.SegmentationDataset(raw, None, labels, None, patch_shape=PATCH, n_samples=1)
    return SPOCOTrainer(name=name, model=model, train_loader=port.DataLoader(train), val_loader=port.DataLoader(val),
                        loss=loss.SPOCOLoss(**LOSS), metric=loss.ContrastiveLoss(0.75, 2.0, max_instances=16),
                        momentum=MOMENTUM, device="cpu", mixed_precision=False, logger=None,
                        save_root=str(tmp_path), **kwargs)


def test_spoco_trainer_matches_jax(spoco_setup, tmp_path, monkeypatch):
    """Three f32 steps of the port's SPOCOTrainer against the JAX package's, each step's loss
    given the anchors that the JAX step draws from its key. Parameters and model2 within 1e-4
    (steps of lr 1e-4); the upsamplers' biases, whose gradient is rounding noise that AdamW
    normalises (``tests/test_torch_training.py``), are held by their effect on the output."""
    import copy

    from torch_em_tpu.data.loader import DataLoader as JaxDataLoader
    from torch_em_tpu.data.segmentation_dataset import SegmentationDataset as JaxSegmentationDataset
    from torch_em_tpu.trainer.spoco_trainer import SPOCOTrainer as JaxSPOCOTrainer

    raw, labels, jax_model, _ = spoco_setup
    jax_loss = jax_spoco.SPOCOLoss(**LOSS)
    train = JaxSegmentationDataset(raw, None, labels, None, patch_shape=PATCH, n_samples=ITERATIONS)
    val = JaxSegmentationDataset(raw, None, labels, None, patch_shape=PATCH, n_samples=1)
    np.random.seed(DATA_SEED)
    jax_trainer = JaxSPOCOTrainer(
        name="spoco", model=copy.copy(jax_model), train_loader=JaxDataLoader(train), val_loader=JaxDataLoader(val),
        loss=jax_loss, metric=JaxContrastiveLoss(0.75, 2.0, max_instances=16), momentum=MOMENTUM, device="cpu",
        mixed_precision=False, logger=None, save_root=str(tmp_path / "jax"))
    jax_trainer.fit(iterations=ITERATIONS)

    trainer = _port_trainer(spoco_setup, tmp_path / "port")
    # the keys of the JAX trainer's steps: PRNGKey(seed) split once per step
    keys, key = [], jax.random.PRNGKey(42)
    for _ in range(ITERATIONS):
        key, sub = jax.random.split(key)
        keys.append(sub)
    calls = []
    draw = trainer.loss.draw_anchors

    def jax_draw(mask, generator=None):
        if not torch.is_grad_enabled():  # validation: its anchors change no parameter
            return draw(mask, generator)
        step, b = divmod(len(calls), 1)  # batch size 1
        calls.append(step)
        return torch.from_numpy(_jax_anchors(jax_loss, keys[step], mask.numpy()[None, None])[b].copy())

    monkeypatch.setattr(trainer.loss, "draw_anchors", jax_draw)
    np.random.seed(DATA_SEED)
    trainer.fit(iterations=ITERATIONS)
    assert len(calls) == ITERATIONS and trainer.iteration == jax_trainer.iteration == ITERATIONS
    np.testing.assert_allclose(trainer.current_metric, jax_trainer.current_metric, rtol=1e-5)

    for got, expected in ((trainer.model.state_dict(), _state(jax_trainer.variables)),
                          (trainer.model2.state_dict(), _state(jax_trainer.variables2))):
        for name in got:
            if name not in UPSAMPLER_BIASES:
                np.testing.assert_allclose(got[name].numpy(), expected[name].numpy(), rtol=0, atol=1e-4, err_msg=name)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 1) + PATCH).astype(np.float32))
    with torch.no_grad():
        before = trainer.model2(x)
        for name in UPSAMPLER_BIASES:
            trainer.model2.state_dict()[name].add_(0.5)
        np.testing.assert_allclose(trainer.model2(x).numpy(), before.numpy(), rtol=0, atol=1e-5)


def test_ema_update_matches_jax(spoco_setup, tmp_path):
    """One update of model2 from two unrelated states, against the JAX package's tree_map."""
    trainer = _port_trainer(spoco_setup, tmp_path)
    trainer._ensure_model2()
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for p in list(trainer.model.parameters()) + list(trainer.model2.parameters()):
            p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)))
    t = {k: jnp.asarray(v.numpy()) for k, v in trainer.model2.state_dict().items()}
    s = {k: jnp.asarray(v.numpy()) for k, v in trainer.model.state_dict().items()}
    expected = jax.tree_util.tree_map(lambda a, b: a * MOMENTUM + b * (1.0 - MOMENTUM), t, s)
    trainer.ema_update()
    got = trainer.model2.state_dict()
    assert set(got) == set(expected)
    for name, value in expected.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value), rtol=0, atol=1e-6, err_msg=name)
    assert not any(p.requires_grad for p in trainer.model2.parameters()) and not trainer.model2.training


def test_checkpoint_restores_model2_bitwise(spoco_setup, tmp_path):
    from torch_em_tpu_torch.trainer import DefaultTrainer, SPOCOTrainer

    trainer = _port_trainer(spoco_setup, tmp_path, iterations=2)
    np.random.seed(DATA_SEED)
    trainer.fit(iterations=2)
    resumed = DefaultTrainer.from_checkpoint(trainer.checkpoint_folder, "latest", device="cpu")
    assert isinstance(resumed, SPOCOTrainer) and resumed.momentum == MOMENTUM and resumed.iteration == 2
    expected = trainer.model2.state_dict()
    for name, value in resumed.model2.state_dict().items():
        assert torch.equal(value, expected[name]), name
    # model2 is not the model: it trails it
    name = "out_conv.weight"
    assert not torch.equal(resumed.model2.state_dict()[name], resumed.model.state_dict()[name])
    resumed.fit(iterations=1)
    assert resumed.iteration == 3


def test_losses_see_float32_under_mixed_precision(spoco_setup, tmp_path):
    """The JAX trainer's compute module (bf16 under ``mixed_precision``) casts the U-Net's output to
    float32, so its SPOCO loss gets float32 predictions; the port's does too."""
    raw, labels, jax_model, _ = spoco_setup
    module = jax_model.module.clone(dtype=jnp.bfloat16)
    out = jax.eval_shape(lambda v, x: module.apply(v, x, train=False), jax_model.variables,
                         jax.ShapeDtypeStruct((1, 1) + PATCH, jnp.float32))
    assert out.dtype == jnp.float32

    trainer = _port_trainer(spoco_setup, tmp_path, iterations=1)
    trainer.mixed_precision = True
    seen, computed = [], []
    spoco = trainer.loss

    def spy(pred, y, generator=None):
        seen.append((pred[0].dtype, pred[1].dtype))
        return spoco(pred, y, generator=generator)

    spy.needs_rng = True
    trainer.loss = spy
    trainer._ensure_model2()
    for m in (trainer.model, trainer.model2):
        m.register_forward_pre_hook(lambda module, args: computed.append(module.dtype))
    np.random.seed(DATA_SEED)
    trainer.fit(iterations=1)
    assert seen[0] == (torch.float32, torch.float32) and computed[:2] == [torch.bfloat16, torch.bfloat16]
    assert trainer.model.dtype == trainer.model2.dtype == torch.float32


def test_semisupervised_step(spoco_setup, tmp_path):
    """A semi-supervised pass after the epoch's steps: one more optimizer step and EMA update per batch."""
    import torch_em_tpu_torch as port

    raw, labels, _, _ = spoco_setup
    unlabeled = port.DataLoader(port.data.RawDataset(raw, None, patch_shape=PATCH, n_samples=2))
    trainer = _port_trainer(spoco_setup, tmp_path, iterations=1, semisupervised_loader=unlabeled,
                            semisupervised_loss=loss.SPOCOConsistencyLoss(0.75, 0.9, max_anchors=4))
    np.random.seed(DATA_SEED)
    trainer.fit(iterations=1)
    assert trainer.torch_optimizer.state[next(trainer.model.parameters())]["step"] == 3


# ------------------------------------------------------- the SPOCO quality probe
def _probe():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "torch_spoco2d.py")
    spec = importlib.util.spec_from_file_location("torch_spoco2d", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_make_image_regenerates_the_probe_data():
    """The port's ``make_image`` from seed 42 gives the first train images of
    ``experiments/parity/parity_data/train.h5`` bitwise."""
    import os

    import h5py

    from torch_em_tpu_torch.utils.test import make_image

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments", "parity",
                        "parity_data", "train.h5")
    with h5py.File(path, "r") as f:
        raw, labels = f["raw"][:4], f["labels"][:4]
    rng = np.random.default_rng(42)
    for i in range(4):
        r, lab = make_image(rng)
        np.testing.assert_array_equal(lab, labels[i])
        np.testing.assert_array_equal(r, raw[i])


def test_probe_runs_on_the_cpu(tmp_path):
    """The probe end to end for 2 iterations: data checked against the tracked digests, training,
    grid search and scores."""
    import json

    probe = _probe()
    assert probe.main(["--seeds", "0", "-n", "2", "-d", "cpu", "-o", str(tmp_path)]) == 0
    with open(tmp_path / "spoco_results.json") as f:
        result = json.load(f)
    run = result["runs"][0]
    assert run["iterations"] == 2 and len(run["per_image"]) == 8
    assert run["decode"]["delta"] in probe.GRID["delta"] and np.isfinite(run["mean_voi"])
    assert result["summary"]["mean_gt_instances"]["mean"] == 6.25
