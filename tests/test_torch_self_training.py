"""The port's self-training path against the JAX package's: the pseudo-labelers, the losses,
one step of each trainer, the teacher's moving average, checkpoints, the pseudo-label dataset,
and every trainer of ``chip_smoke.py``'s phase 13 end to end at a small size.

Both sides take the same seeded numpy inputs on the CPU in float32, with the JAX weights carried
over by ``utils.convert``. The trainer steps start from the same student and teacher (the
teacher a perturbed copy, so that its moving average shows) and the same drawn augmentation
parameters (``jax_params`` replays the JAX augmenters' draws). Each JAX trainer is built once:
its steps are called directly, and each compiles once. The steps take SGD, whose
step keeps the gradients' agreement (AdamW's first step divides each gradient by its own
magnitude, so a gradient of rounding noise moves its weight by the full learning rate; AdamW
itself is held by ``tests/test_torch_optim.py``). Tolerances: losses 1e-5 relative;
pseudo-labels 1e-5, their filters equal away from the thresholds; parameters after a step and
the teacher's average 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import torch_em_tpu_torch as port
from test_torch_invertible_augmentations import jax_params
from torch_em_tpu import self_training as jst
from torch_em_tpu.models.base import Model as JaxModel
from torch_em_tpu.models.unet import UNetModule as JaxUNetModule
from torch_em_tpu.trainer import OptimizerSpec as JaxOptimizerSpec
from torch_em_tpu_torch import self_training as st
from torch_em_tpu_torch.utils.convert import state_dict_from_jax_params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers; torch's thread pool in each would oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MODEL = dict(in_channels=1, out_channels=1, depth=2, initial_features=4, final_activation="Sigmoid")
SHAPE = (2, 1, 32, 32)
LR, MOMENTUM, CT = 0.1, 0.9, 0.55
VALUE_TOL, PARAM_TOL = 1e-5, 1e-6


def _state(variables):
    return state_dict_from_jax_params(
        {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(variables["params"]), sep="/").items()})


def _copy(tree):
    """A copy that a donating JAX step may consume."""
    return jax.tree_util.tree_map(jnp.copy, tree)


@pytest.fixture(scope="module")
def setup():
    """The JAX UNet2d (initialised under jit), a perturbed copy as the teacher, and the batches."""
    module = JaxUNetModule(dim=2, features_encoder=(4, 8), scale_factors=(2, 2), in_channels=1, out_channels=1,
                           final_activation="Sigmoid")
    example = jnp.zeros((1, 1, 4, 4))
    jax_model = JaxModel(module, init_kwargs={}, example_input_shape=example.shape, in_channels=1, out_channels=1,
                         eager_init=False)
    jax_model.variables = jax.jit(lambda rng, x: module.init(rng, x, train=False))(jax.random.PRNGKey(0), example)
    leaves, tree = jax.tree_util.tree_flatten(jax_model.variables)
    rng = np.random.default_rng(1)
    teacher = jax.tree_util.tree_unflatten(
        tree, [leaf + 0.05 * rng.normal(size=leaf.shape).astype(np.float32) for leaf in leaves])
    rng = np.random.default_rng(2)
    xu1 = rng.normal(size=SHAPE).astype(np.float32)
    xu2 = (xu1 + 0.1 * rng.normal(size=SHAPE)).astype(np.float32)
    xs = rng.normal(size=SHAPE).astype(np.float32)
    ys = (xs > 0.3).astype(np.float32)
    return jax_model, teacher, {"xu1": xu1, "xu2": xu2, "xs": xs, "ys": ys}


def _port_model(variables):
    model = port.UNet2d(**MODEL, device="cpu")
    model.load_state_dict(_state(variables), strict=True)
    return model


def _jax_kwargs(tmp_path, data):
    unsup = [(data["xu1"], data["xu2"])]
    return dict(unsupervised_train_loader=unsup, unsupervised_val_loader=unsup,
                unsupervised_loss=jst.DefaultSelfTrainingLoss(),
                unsupervised_loss_and_metric=jst.DefaultSelfTrainingLossAndMetric(),
                pseudo_labeler=jst.DefaultPseudoLabeler(confidence_threshold=CT),
                optimizer=JaxOptimizerSpec("sgd", lr=LR), device="cpu", mixed_precision=False, logger=None,
                save_root=str(tmp_path / "jax"))


def _port_trainer(cls, setup, tmp_path, supervised=False, **kwargs):
    jax_model, teacher, data = setup
    unsup = [(data["xu1"], data["xu2"])]
    if supervised:
        sup = [(data["xs"], data["ys"])]
        kwargs.update(supervised_train_loader=sup, supervised_val_loader=sup, supervised_loss=st.DefaultSelfTrainingLoss(),
                      supervised_loss_and_metric=st.DefaultSelfTrainingLossAndMetric())
    trainer = cls(name="st", model=_port_model(jax_model.variables), unsupervised_train_loader=unsup,
                  unsupervised_val_loader=unsup, unsupervised_loss=st.DefaultSelfTrainingLoss(),
                  unsupervised_loss_and_metric=st.DefaultSelfTrainingLossAndMetric(),
                  pseudo_labeler=st.DefaultPseudoLabeler(confidence_threshold=CT),
                  optimizer=port.OptimizerSpec("sgd", lr=LR), device="cpu", mixed_precision=False, logger=None,
                  save_root=str(tmp_path / "port"), **kwargs)
    trainer._initialize(1, None)
    if trainer.teacher is not trainer.model:
        trainer.teacher.load_state_dict(_state(teacher))
    return trainer


def _t(x):
    return torch.from_numpy(x)


def _check_labels(got, expected):
    pseudo, filt = got
    jax_pseudo, jax_filt = (np.asarray(a) for a in expected)
    np.testing.assert_allclose(pseudo.numpy(), jax_pseudo, rtol=0, atol=VALUE_TOL)
    away = (np.abs(jax_pseudo - CT) > VALUE_TOL) & (np.abs(jax_pseudo - (1 - CT)) > VALUE_TOL)
    np.testing.assert_array_equal(filt.numpy()[away], jax_filt[away])
    assert 0 < jax_filt.mean() < 1


def _check_step(loss, jax_loss, model, variables, teacher=None, jax_teacher=None):
    assert abs(float(loss) - float(jax_loss)) <= VALUE_TOL * max(1.0, abs(float(jax_loss)))
    pairs = [(model, variables)] + ([] if teacher is None else [(teacher, jax_teacher)])
    for network, expected in pairs:
        expected = _state(expected)
        for name, got in network.state_dict().items():
            np.testing.assert_allclose(got.numpy(), expected[name].numpy(), rtol=0, atol=PARAM_TOL, err_msg=name)


@pytest.fixture(scope="module")
def jax_mean_teacher(setup, tmp_path_factory):
    """One JAX MeanTeacherTrainer, semi-supervised, so that it builds both steps."""
    jax_model, teacher, data = setup
    sup = [(data["xs"], data["ys"])]
    trainer = jst.MeanTeacherTrainer(
        name="mt", model=copy.copy(jax_model), supervised_train_loader=sup, supervised_val_loader=sup,
        supervised_loss=jst.DefaultSelfTrainingLoss(), supervised_loss_and_metric=jst.DefaultSelfTrainingLossAndMetric(),
        reinit_teacher=False, **_jax_kwargs(tmp_path_factory.mktemp("mt"), data))
    trainer._initialize(1, None)
    return trainer


def test_mean_teacher_unsupervised_step_matches_jax(setup, jax_mean_teacher, tmp_path):
    jax_model, teacher, data = setup
    jt, key = jax_mean_teacher, jax.random.PRNGKey(3)
    labels = jt._pseudo_label_step(teacher, data["xu1"], jnp.float32(CT), key)
    variables, jax_teacher, _, jax_loss = jt._unsup_step(
        _copy(jax_model.variables), _copy(teacher), _copy(jt.opt_state), data["xu2"], *labels, key,
        jnp.float32(MOMENTUM))
    trainer = _port_trainer(st.MeanTeacherTrainer, setup, tmp_path, momentum=MOMENTUM)
    loss, pseudo, filt = trainer._unsupervised_step(_t(data["xu1"]), _t(data["xu2"]))
    _check_labels((pseudo, filt), labels)
    _check_step(loss, jax_loss, trainer.model, variables, trainer.teacher, jax_teacher)


def test_mean_teacher_semisupervised_step_matches_jax(setup, jax_mean_teacher, tmp_path):
    jax_model, teacher, data = setup
    jt, key = jax_mean_teacher, jax.random.PRNGKey(4)
    labels = jt._pseudo_label_step(teacher, data["xu1"], jnp.float32(CT), key)
    variables, jax_teacher, _, jax_loss, jax_sup, jax_unsup = jt._semisup_step(
        _copy(jax_model.variables), _copy(teacher), _copy(jt.opt_state), data["xs"], data["ys"], data["xu2"],
        *labels, key, jnp.float32(MOMENTUM))
    trainer = _port_trainer(st.MeanTeacherTrainer, setup, tmp_path, supervised=True, momentum=MOMENTUM,
                            reinit_teacher=False)
    loss, sup, unsup, _, _ = trainer._semisupervised_step(*(_t(data[k]) for k in ("xs", "ys", "xu1", "xu2")))
    for a, b in ((sup, jax_sup), (unsup, jax_unsup)):
        assert abs(float(a) - float(b)) <= VALUE_TOL * abs(float(b))
    _check_step(loss, jax_loss, trainer.model, variables, trainer.teacher, jax_teacher)


def test_warm_up_momentum_and_fresh_teacher(setup, jax_mean_teacher, tmp_path):
    """With reinit_teacher (the default of a semi-supervised run) the momentum warms up as the JAX
    package's, and the teacher is the factory's model seeded seed + 1."""
    trainer = _port_trainer(st.MeanTeacherTrainer, setup, tmp_path, supervised=True, momentum=0.99)
    assert trainer.reinit_teacher
    jt = copy.copy(jax_mean_teacher)
    jt.reinit_teacher, jt.momentum = True, 0.99
    for it in (0, 1, 5, 1000):
        trainer._iteration = jt._iteration = it
        assert trainer._current_momentum() == jt._current_momentum()
    fresh = port.UNet2d(**MODEL, device="cpu", seed=trainer.seed + 1)
    trainer._init_teacher(reinit=True)
    for name, value in fresh.state_dict().items():
        assert torch.equal(trainer.teacher.state_dict()[name], value), name
    assert not any(p.requires_grad for p in trainer.teacher.parameters()) and not trainer.teacher.training


def test_ema_update_matches_jax(setup, tmp_path):
    """One update of the teacher from two unrelated states at a warm-up momentum, against the
    JAX step's update over all variables in float32."""
    trainer = _port_trainer(st.MeanTeacherTrainer, setup, tmp_path, momentum=MOMENTUM)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)))
    t = {k: jnp.asarray(v.numpy()) for k, v in trainer.teacher.state_dict().items()}
    s = {k: jnp.asarray(v.numpy()) for k, v in trainer.model.state_dict().items()}
    m = jnp.float32(1 - 1 / 3)
    expected = jax.tree_util.tree_map(lambda a, b: a * m + b * (1.0 - m), t, s)
    trainer.reinit_teacher, trainer._iteration = True, 2  # the warm-up momentum min(1 - 1/3, MOMENTUM)
    trainer.ema_update()
    for name, value in trainer.teacher.state_dict().items():
        np.testing.assert_allclose(value.numpy(), np.asarray(expected[name]), rtol=0, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def jax_fix_match(setup, tmp_path_factory):
    jax_model, _, data = setup
    trainer = jst.FixMatchTrainer(name="fm", model=copy.copy(jax_model), source_distribution=[0.7, 0.3],
                                  **_jax_kwargs(tmp_path_factory.mktemp("fm"), data))
    trainer._initialize(1, None)
    return trainer


def test_fix_match_step_with_distribution_alignment_matches_jax(setup, jax_fix_match, tmp_path):
    jax_model, _, data = setup
    jt, key = jax_fix_match, jax.random.PRNGKey(6)
    labels = jt._pseudo_label_step(_copy(jax_model.variables), data["xu1"], jnp.float32(CT), key)
    variables, jax_teacher, _, jax_loss = jt._unsup_step(
        _copy(jax_model.variables), _copy(jax_model.variables), _copy(jt.opt_state), data["xu2"], *labels, key,
        jnp.float32(jt._current_momentum()))
    trainer = _port_trainer(st.FixMatchTrainer, setup, tmp_path, source_distribution=[0.7, 0.3])
    assert trainer.teacher is trainer.model and trainer._compute_models() == [trainer.model]
    aligned = trainer._distribution_alignment(torch.linspace(0, 1, 11))
    np.testing.assert_allclose(aligned.numpy(), np.asarray(jt._distribution_alignment(jnp.linspace(0, 1, 11))),
                               rtol=1e-6)
    trainer.model.train()  # as in the epoch's loop
    loss, pseudo, filt = trainer._unsupervised_step(_t(data["xu1"]), _t(data["xu2"]))
    _check_labels((pseudo, filt), labels)
    _check_step(loss, jax_loss, trainer.model, variables)
    _check_step(loss, jax_loss, trainer.model, jax_teacher)  # the JAX teacher follows its student
    assert trainer.model.training  # the pseudo-labelling forward ran in eval mode and left it


@pytest.fixture(scope="module")
def jax_unimatch(setup, tmp_path_factory):
    jax_model, _, data = setup
    kwargs = _jax_kwargs(tmp_path_factory.mktemp("um"), data)
    kwargs.update(unsupervised_loss=jst.DefaultUnimatchLoss(),
                  unsupervised_loss_and_metric=jst.DefaultUnimatchLossAndMetric())
    trainer = jst.UniMatchv2Trainer(name="um", model=copy.copy(jax_model),
                                    augmenter=jst.UniMatchv2Augmenters(ndim=2), **kwargs)
    trainer._initialize(1, None)
    return trainer


def test_unimatch_step_matches_jax(setup, jax_unimatch, tmp_path, monkeypatch):
    jax_model, teacher, data = setup
    jt, key = jax_unimatch, jax.random.PRNGKey(8)
    variables, jax_teacher, _, jax_loss = jt._unimatch_step(
        _copy(jax_model.variables), _copy(teacher), _copy(jt.opt_state), data["xu1"], jnp.float32(CT), key,
        jnp.float32(MOMENTUM))
    trainer = _port_trainer(st.UniMatchv2Trainer, setup, tmp_path, momentum=MOMENTUM,
                            augmenter=st.UniMatchv2Augmenters(ndim=2))
    trainer.unsupervised_loss = st.DefaultUnimatchLoss()
    keys = jax.random.split(key, 4)
    drawn = []
    for name, k in zip(("weak", "strong1", "strong2"), keys):
        params = jax_params(getattr(jt.augmenter, name), k, data["xu1"])
        drawn.append(params)
        monkeypatch.setattr(getattr(trainer.augmenter, name), "draw", lambda x, *g, params=params: params)
    assert any(p["k"] for p in drawn) and any(p.get("noise") is not None for p in drawn)
    (loss,) = trainer._unimatch_step(_t(data["xu1"]))
    _check_step(loss, jax_loss, trainer.model, variables, trainer.teacher, jax_teacher)


def test_invertible_mean_teacher_warps_the_student_view(setup, tmp_path, monkeypatch):
    """The student sees the warped view, and its prediction is warped back."""
    _, _, data = setup
    params = {"hflip": True, "vflip": False, "k": 1}
    trainer = _port_trainer(st.MeanTeacherTrainerWithInvertibleAugmentations, setup, tmp_path,
                            augmenter=st.MeanTeacherAugmenters(ndim=2))
    seen = []
    monkeypatch.setattr(trainer.augmenter.student, "draw", lambda x, *g: seen.append(x) or params)
    student = trainer._unsupervised_apply()
    x = _t(data["xu2"])
    with torch.no_grad():
        warped_pred = student(x)
        expected = torch.rot90(trainer.model(torch.rot90(x.flip(-1), 1, (2, 3))), -1, (2, 3)).flip(-1)
        plain = trainer.model(x)
    assert len(seen) == 1 and torch.equal(warped_pred, expected) and not torch.allclose(warped_pred, plain)


# ------------------------------------------------------------ pseudo-labelers
def _logits(channels=2, seed=0):
    return np.random.default_rng(seed).normal(scale=2.0, size=(2, channels, 8, 8)).astype(np.float32)


@pytest.mark.parametrize("kwargs", [dict(confidence_threshold=0.8), dict(confidence_threshold=0.7, mask_channel=1),
                                    dict(confidence_threshold=0.8, threshold_from_both_sides=False), dict()],
                         ids=["both-sides", "mask-channel", "one-side", "no-threshold"])
def test_default_pseudo_labeler_matches_jax(kwargs):
    logits = _logits()
    got = st.DefaultPseudoLabeler(activation="Sigmoid", **kwargs)(lambda x: x, _t(logits))
    expected = jst.DefaultPseudoLabeler(activation=jax.nn.sigmoid, **kwargs)(lambda x: x, jnp.asarray(logits))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(expected[0]), rtol=0, atol=1e-6)
    if "confidence_threshold" not in kwargs:
        assert got[1] is None and expected[1] is None
        return
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(expected[1]))
    assert got[1].shape == got[0].shape and 0 < float(got[1].mean()) < 1
    if "mask_channel" in kwargs:
        assert torch.equal(got[1][:, 0], got[1][:, 1])


def test_scheduled_pseudo_labeler_matches_jax():
    kwargs = dict(confidence_threshold=0.9, patience=1, factor=0.1, min_ct=0.65)
    ours, theirs = st.ScheduledPseudoLabeler(**kwargs), jst.ScheduledPseudoLabeler(**kwargs)
    thresholds = []
    for epoch, metric in enumerate([1.0, 0.9, 0.95, 0.97, 0.96, 0.99, 0.98, 0.99, 0.995]):
        ours.step(metric, epoch)
        theirs.step(metric, epoch)
        assert ours.confidence_threshold == pytest.approx(theirs.confidence_threshold)
        thresholds.append(ours.confidence_threshold)
    assert thresholds[0] == 0.9 and min(thresholds) == 0.65 and len(set(thresholds)) == 4
    for mode in (dict(mode="max"), dict(threshold_mode="abs")):
        ours, theirs = st.ScheduledPseudoLabeler(**kwargs, **mode), jst.ScheduledPseudoLabeler(**kwargs, **mode)
        for epoch, metric in enumerate([0.5, 0.4, 0.45, 0.6, 0.3, 0.2]):
            ours.step(metric, epoch)
            theirs.step(metric, epoch)
            assert ours.confidence_threshold == pytest.approx(theirs.confidence_threshold)
    with pytest.raises(ValueError):
        st.ScheduledPseudoLabeler(mode="middle")


@pytest.mark.parametrize("consensus_masking", [False, True])
def test_probabilistic_pseudo_labeler_with_given_samples(consensus_masking):
    samples = [_logits(1, seed=s) for s in range(4)]
    kwargs = dict(confidence_threshold=0.75, prior_samples=4, consensus_masking=consensus_masking)
    ours_iter, theirs_iter = iter(samples), iter(samples)
    ours = st.ProbabilisticPseudoLabeler(activation="Sigmoid", **kwargs)
    got = ours(lambda x, generator: _t(next(ours_iter)), None, generator=torch.Generator())
    expected = jst.ProbabilisticPseudoLabeler(activation=jax.nn.sigmoid, **kwargs)(
        lambda x, key: jnp.asarray(next(theirs_iter)), None, rng=jax.random.PRNGKey(0))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(expected[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(expected[1]), rtol=0, atol=1e-6)
    assert ours.needs_rng and 0 < float(got[1].mean()) < 1


# ---------------------------------------------------------------------- losses
@pytest.mark.parametrize("with_filter", [False, True])
def test_self_training_losses_match_jax(with_filter):
    pred, labels = _logits(2, seed=1), 1 / (1 + np.exp(-_logits(2, seed=2)))
    filt = (np.random.default_rng(3).random(pred.shape) > 0.4).astype(np.float32) if with_filter else None
    args = (_t(labels), None if filt is None else _t(filt))
    jax_args = (jnp.asarray(labels), None if filt is None else jnp.asarray(filt))
    got = st.DefaultSelfTrainingLoss(activation="Sigmoid")(lambda x: x, _t(pred), *args)
    expected = jst.DefaultSelfTrainingLoss(activation=jax.nn.sigmoid)(lambda x: x, jnp.asarray(pred), *jax_args)
    assert abs(float(got) - float(expected)) <= VALUE_TOL
    got = st.DefaultSelfTrainingLossAndMetric(activation="Sigmoid")(lambda x: x, _t(pred), *args)
    expected = jst.DefaultSelfTrainingLossAndMetric(activation=jax.nn.sigmoid)(lambda x: x, jnp.asarray(pred),
                                                                              *jax_args)
    for a, b in zip(got, expected):
        assert abs(float(a) - float(b)) <= VALUE_TOL
    assert (float(got[0]) != float(got[1])) == with_filter


@pytest.mark.parametrize("with_filter", [False, True])
def test_unimatch_losses_match_jax(with_filter):
    preds = np.stack([_logits(2, seed=4), _logits(2, seed=5)])
    labels = 1 / (1 + np.exp(-_logits(2, seed=6)))
    filt = (np.random.default_rng(7).random(labels.shape) > 0.4).astype(np.float32) if with_filter else None
    args = (_t(labels), None if filt is None else _t(filt))
    jax_args = (jnp.asarray(labels), None if filt is None else jnp.asarray(filt))
    got = st.DefaultUnimatchLoss(activation="Sigmoid")(_t(preds), *args)
    expected = jst.DefaultUnimatchLoss(activation=jax.nn.sigmoid)(jnp.asarray(preds), *jax_args)
    assert abs(float(got) - float(expected)) <= VALUE_TOL
    got = st.DefaultUnimatchLossAndMetric(activation="Sigmoid")(_t(preds), *args)
    expected = jst.DefaultUnimatchLossAndMetric(activation=jax.nn.sigmoid)(jnp.asarray(preds), *jax_args)
    for a, b in zip(got, expected):
        assert abs(float(a) - float(b)) <= VALUE_TOL


# --------------------------------------------------------- pseudo-label dataset
def test_pseudo_label_dataset_matches_jax():
    from torch_em_tpu.data import PseudoLabelDataset as JaxPseudoLabelDataset
    from torch_em_tpu_torch.trainer.serialization import deserialize_value, serialize_value

    raw = np.random.default_rng(8).random((40, 48)).astype(np.float32)

    def threshold(batch):
        return batch > 0.5

    kwargs = dict(patch_shape=(16, 16), pseudo_labeler=threshold, label_transform=lambda y: 2 * y, n_samples=3)
    ours, theirs = port.data.PseudoLabelDataset(raw, None, **kwargs), JaxPseudoLabelDataset(raw, None, **kwargs)
    for i in range(3):
        np.random.seed(i)
        a = ours[i]
        np.random.seed(i)
        b = theirs[i]
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, np.asarray(v))
        assert a[0].shape == a[1].shape == (1, 16, 16) and set(np.unique(a[1])) <= {0.0, 2.0}
    spec = serialize_value(port.data.PseudoLabelDataset(raw, None, (16, 16), pseudo_labeler=np.round, n_samples=2))
    assert len(deserialize_value(spec)) == 2


# ------------------------------------------------------------ end to end
def _loaders(seed=9):
    from torch_em_tpu_torch.data import RawDataset
    from torch_em_tpu_torch.transforms import get_default_mean_teacher_augmentations

    raw = np.random.default_rng(seed).normal(size=(64, 64)).astype(np.float32)
    labels = (raw > 0.3).astype(np.float32)
    aug = get_default_mean_teacher_augmentations(p=0.5)

    def unsup(n):
        return port.DataLoader(RawDataset(raw, None, (32, 32), augmentations=(aug, aug), n_samples=n), batch_size=2)

    def sup(n):
        return port.DataLoader(port.SegmentationDataset(raw, None, labels, None, patch_shape=(32, 32), n_samples=n),
                               batch_size=2)

    return unsup, sup


def _trainer(kind, save_root):
    unsup, sup = _loaders()
    model = port.UNet2d(**MODEL, device="cpu")
    common = dict(name=kind, model=model, optimizer=port.OptimizerSpec("adamw", lr=LR), device="cpu",
                  mixed_precision=False, logger=None, save_root=save_root)
    if kind == "flashoptim":
        return port.trainer.FlashOptimTrainer(train_loader=sup(4), val_loader=sup(2), loss=port.DiceLoss(),
                                              metric=port.DiceLoss(), **common)
    common.update(unsupervised_train_loader=unsup(4), unsupervised_val_loader=unsup(2),
                  unsupervised_loss=st.DefaultSelfTrainingLoss(),
                  unsupervised_loss_and_metric=st.DefaultSelfTrainingLossAndMetric(),
                  pseudo_labeler=st.DefaultPseudoLabeler(confidence_threshold=0.9))
    if kind == "mean_teacher":
        return st.MeanTeacherTrainer(**common)
    if kind == "mean_teacher_semisupervised":
        return st.MeanTeacherTrainer(supervised_train_loader=sup(4), supervised_val_loader=sup(2),
                                     supervised_loss=st.DefaultSelfTrainingLoss(),
                                     supervised_loss_and_metric=st.DefaultSelfTrainingLossAndMetric(), **common)
    if kind == "mean_teacher_invertible":
        return st.MeanTeacherTrainerWithInvertibleAugmentations(augmenter=st.MeanTeacherAugmenters(2), **common)
    if kind == "fix_match":
        return st.FixMatchTrainerWithInvertibleAugmentations(augmenter=st.FixMatchAugmenters(2),
                                                            source_distribution=[0.6, 0.4], **common)
    common.update(unsupervised_loss=st.DefaultUnimatchLoss(), unsupervised_loss_and_metric=st.DefaultUnimatchLossAndMetric())
    return st.UniMatchv2Trainer(augmenter=st.UniMatchv2Augmenters(2), **common)


@pytest.mark.parametrize("kind", ["mean_teacher", "mean_teacher_semisupervised", "mean_teacher_invertible",
                                  "fix_match", "unimatch", "flashoptim"])
def test_trainer_fits_writes_checkpoints_and_resumes(kind, tmp_path):
    trainer = _trainer(kind, str(tmp_path))
    torch.manual_seed(0)
    np.random.seed(0)
    trainer.fit(iterations=2)
    assert trainer.iteration == 2 and np.isfinite(trainer.current_metric)
    folder = trainer.checkpoint_folder
    resumed = port.DefaultTrainer.from_checkpoint(folder, "latest", device="cpu")
    assert type(resumed) is type(trainer)
    teacher = getattr(trainer, "teacher", None)
    if teacher is not None:
        saved = torch.load(f"{folder}/latest.ckpt", weights_only=True)["teacher_state"]
        for name, value in resumed.teacher.state_dict().items():
            assert torch.equal(value, saved[name]) and torch.equal(value, teacher.state_dict()[name]), name
        if kind == "fix_match":
            assert resumed.teacher is resumed.model and resumed.augmenter.student.kind == "strong"
        else:
            assert not torch.equal(resumed.teacher.state_dict()["out_conv.weight"],
                                   resumed.model.state_dict()["out_conv.weight"])
    resumed.fit(iterations=2)
    assert resumed.iteration == 4 and np.isfinite(resumed.current_metric)
    if kind == "flashoptim":
        assert {p.dtype for p in resumed.model.parameters()} == {torch.bfloat16}
        moments = [v for s in resumed.torch_optimizer.state.values() for k, v in s.items() if k != "step"]
        assert moments and {v.dtype for v in moments} == {torch.bfloat16}


class _CallLog:
    """A logger that records each call: its name, its step, the trainer's iteration when it was
    made, and whether it was given images."""

    def __init__(self, trainer, save_root, **kwargs):
        self.trainer, self.calls = trainer, []

    def __getattr__(self, name):
        if not name.startswith("log_"):
            raise AttributeError(name)

        def record(step, *args):
            images = any(torch.is_tensor(a) and a.ndim == 4 for a in args)
            self.calls.append((name, step, self.trainer._iteration, images))

        return record


@pytest.mark.parametrize("kind", ["mean_teacher", "mean_teacher_semisupervised", "unimatch"])
def test_train_logs_are_buffered(kind, tmp_path):
    """As DefaultTrainer's, the self-training logs of a step are kept until a step logs images or the
    epoch ends, so reading a loss does not make each step wait for the device; every step is logged,
    and only the image steps with their images."""
    trainer = _trainer(kind, str(tmp_path))
    trainer.logger_class, trainer.log_image_interval = _CallLog, 2
    trainer.fit(iterations=3)
    train = [c for c in trainer.logger.calls if not c[0].startswith("log_validation")]
    unsupervised = [c for c in train if c[0] == "log_train_unsupervised"]
    assert [c[1] for c in unsupervised] == [0, 1, 2]
    assert [c[2] for c in unsupervised] == [0, 2, 2]  # step 1 was written with step 2's images
    assert [c[3] for c in unsupervised] == [True, False, True]
    assert [c[1] for c in train if c[0] == "log_lr"] == [0, 1, 2]


def test_trainers_refuse_what_the_jax_package_refuses(tmp_path):
    unsup, sup = _loaders()
    model = port.UNet2d(**MODEL, device="cpu")
    with pytest.raises(ValueError, match="AdamW"):
        port.trainer.FlashOptimTrainer(name="f", model=model, train_loader=sup(2), val_loader=sup(2),
                                       loss=port.DiceLoss(), metric=port.DiceLoss(), device="cpu",
                                       optimizer=port.OptimizerSpec("sgd", lr=0.1))
    flash = port.trainer.FlashOptimTrainer(name="f", model=model, train_loader=sup(2), val_loader=sup(2),
                                           loss=port.DiceLoss(), metric=port.DiceLoss(), device="cpu",
                                           mixed_precision=False)
    assert flash.mixed_precision
    with pytest.raises(ValueError, match="UniMatchv2Augmenters"):
        st.UniMatchv2Trainer(name="u", model=model, unsupervised_train_loader=unsup(2),
                             unsupervised_val_loader=unsup(2), unsupervised_loss=st.DefaultUnimatchLoss(),
                             unsupervised_loss_and_metric=st.DefaultUnimatchLossAndMetric(),
                             pseudo_labeler=st.DefaultPseudoLabeler(), device="cpu")
    with pytest.raises(ValueError, match="supervised_loss"):
        st.MeanTeacherTrainer(name="m", model=model, unsupervised_train_loader=unsup(2), supervised_train_loader=sup(2),
                              unsupervised_val_loader=unsup(2), unsupervised_loss=st.DefaultSelfTrainingLoss(),
                              unsupervised_loss_and_metric=st.DefaultSelfTrainingLossAndMetric(), device="cpu")


@pytest.mark.filterwarnings("ignore:Could not serialize trainer kwarg sampler")
def test_sampler_turns_batches_down(tmp_path):
    """A sampler that turns every other batch down: those batches take no step (the JAX loop's
    ``continue``), the pseudo-labels reach it as numpy arrays."""
    unsup, _ = _loaders()
    seen = []

    def sampler(pseudo_labels, label_filter):
        seen.append((type(pseudo_labels), type(label_filter)))
        return len(seen) % 2 == 0

    trainer = st.MeanTeacherTrainer(
        name="s", model=port.UNet2d(**MODEL, device="cpu"), unsupervised_train_loader=unsup(8),
        unsupervised_val_loader=unsup(2), unsupervised_loss=st.DefaultSelfTrainingLoss(),
        unsupervised_loss_and_metric=st.DefaultSelfTrainingLossAndMetric(),
        pseudo_labeler=st.DefaultPseudoLabeler(confidence_threshold=0.9), sampler=sampler, device="cpu",
        mixed_precision=False, logger=None, save_root=str(tmp_path))
    trainer.fit(iterations=2)
    assert trainer.iteration == 2 and len(seen) == 4 and seen[0] == (np.ndarray, np.ndarray)
