"""The port's classification path against the JAX package's, on the CPU.

- ``CrossEntropyLoss`` against the JAX loss on the same logits and targets
  (float32, within 1e-6);
- ``ClassificationMetric``: its numpy accuracy equals sklearn's
  ``accuracy_score`` (also unnormalised and weighted); every other score of
  two label vectors (``classification/scores.py``) equals sklearn's with its
  arguments (``average``, ``labels``, ``pos_label``, ``sample_weight``,
  ``zero_division`` and the score's own) within 1e-12, on seeded binary,
  multiclass and gapped label vectors, live and as recorded by
  ``scripts/make_forest_fixtures.py`` (which ``chip_smoke.py`` phase 21
  checks on the card); a score the port does not compute takes sklearn's
  function, an unknown one raises;
- ``ClassificationDataset`` and ``default_classification_loader`` give the
  JAX package's samples (standardized, resized, no augmentation) and
  batches of the right shapes;
- one ``ClassificationTrainer`` step with SGD on a small 3-D ResNet (one
  block per stage), the JAX trainer's ``_train_step`` against the port's,
  in float64 on both sides (``jax.enable_x64``; the batch norms of the last
  stages see two values per channel, where float32 gradients lie percents
  apart): the loss within 1e-6, the parameters after the step within 1e-5
  of their largest change plus one float32 rounding of their size (the
  converter carries the JAX side's values in float32);
- validation over the whole set, argmax predictions scored at once; NaN
  predictions warn;
- ``default_classification_trainer`` with ``resnet3d_18`` fits, rebuilds
  from its checkpoint and resumes on the CPU, and its ``ClassificationLogger``
  writes the confusion matrix.
"""

import copy
import functools
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from torch_em_tpu.classification import ClassificationDataset as JaxClassificationDataset
from torch_em_tpu.classification import ClassificationTrainer as JaxClassificationTrainer
from torch_em_tpu.classification.classification import CrossEntropyLoss as JaxCrossEntropyLoss
from torch_em_tpu.models.base import Model as JaxModel
from torch_em_tpu.models.resnet3d import ResNet3dModule as JaxResNet3dModule
from torch_em_tpu.trainer import OptimizerSpec as JaxOptimizerSpec
from torch_em_tpu.transforms.raw import standardize as jax_standardize
import torch_em_tpu_torch as port
from torch_em_tpu_torch.classification import (
    ClassificationDataset, ClassificationLogger, ClassificationMetric, ClassificationTrainer, CrossEntropyLoss,
    default_classification_loader, default_classification_trainer,
)
from torch_em_tpu_torch.classification.scores import SCORES
from torch_em_tpu_torch.models.resnet3d import ResNet3dModule
from torch_em_tpu_torch.transforms.raw import standardize
from torch_em_tpu_torch.utils.convert import resnet3d_state_dict_from_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import make_forest_fixtures as fixtures  # noqa: E402

SMALL = dict(block="basic", layers=(1, 1, 1, 1), in_channels=1, out_channels=3)
LR = 0.1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Six test workers' thread pools oversubscribe the CPU; one thread per worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _volumes(n, shape=(1, 16, 16, 16), seed=0):
    rng = np.random.default_rng(seed)
    data = [rng.normal(loc=i % 3, size=shape).astype(np.float32) for i in range(n)]
    return data, np.arange(n) % 3


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 4)).astype(np.float32) * 3
    target = rng.integers(0, 4, size=6)
    expected = float(JaxCrossEntropyLoss()(jnp.asarray(logits), jnp.asarray(target)))
    got = float(CrossEntropyLoss()(torch.from_numpy(logits), torch.from_numpy(target)))
    np.testing.assert_allclose(got, expected, rtol=1e-6)
    assert CrossEntropyLoss().init_kwargs == {}


@pytest.mark.parametrize("kwargs", [{}, {"normalize": False}, {"sample_weight": [1, 2, 0.5, 1, 3, 1, 1, 2]}],
                         ids=["default", "count", "weighted"])
def test_numpy_accuracy_equals_sklearn(kwargs):
    from sklearn.metrics import accuracy_score

    y_true = np.array([0, 1, 2, 2, 1, 0, 3, 3])
    y_pred = np.array([0, 2, 2, 2, 1, 1, 3, 0])
    metric = ClassificationMetric(**kwargs)
    assert metric(y_true, y_pred) == pytest.approx(1.0 - accuracy_score(y_true, y_pred, **kwargs), abs=1e-12)
    assert metric.init_kwargs == {"metric_name": "accuracy_score", **kwargs}


@pytest.mark.parametrize("name, label_set, kwargs", [(n, s, k) for n, s, k in fixtures.SCORE_CASES]
                         + [("roc_auc_score", "binary", {})],
                         ids=lambda v: str(v))
def test_other_metrics_come_from_sklearn(name, label_set, kwargs):
    """Every score of two label vectors, computed in numpy, against sklearn's with the same arguments;
    a score the port does not compute is sklearn's own function."""
    import sklearn.metrics

    labels = fixtures.score_labels()
    y_true, y_pred = (np.asarray(v) for v in labels[label_set])
    kwargs = fixtures.score_kwargs(kwargs, labels)
    metric = ClassificationMetric(name, **kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        expected = np.asarray(getattr(sklearn.metrics, name)(y_true, y_pred, **kwargs), dtype=np.float64)
        got = np.asarray(metric(y_true, y_pred), dtype=np.float64)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, 1.0 - expected, rtol=0, atol=1e-12)
    assert (metric.metric is getattr(sklearn.metrics, name)) == (name not in SCORES)
    assert metric.init_kwargs == {"metric_name": name, **kwargs}


def test_recorded_scores_match():
    """The scores recorded by sklearn in scripts/records/forest/classification_scores.json."""
    errors = fixtures.score_errors()
    assert len(errors) == len(fixtures.SCORE_CASES)
    assert max(err for *_, err in errors) <= 1e-12


def test_unknown_metric_name_raises():
    with pytest.raises(ValueError, match="Invalid metric_name"):
        ClassificationMetric("no_such_score")


@pytest.mark.parametrize("name, kwargs, match", [
    ("f1_score", {"average": "binary"}, "multiclass but average='binary'"),
    ("precision_score", {"pos_label": 7}, "pos_label=7 is not a valid label"),
    ("jaccard_score", {"average": "samples"}, "Samplewise metrics"),
    ("recall_score", {"average": "most"}, "average"),
])
def test_score_errors_match_sklearn(name, kwargs, match):
    """Arguments that sklearn refuses are refused alike."""
    import sklearn.metrics

    y_true, y_pred = np.array([0, 1, 2, 1]), np.array([0, 2, 2, 1])
    if name == "precision_score":
        y_true, y_pred = y_true % 2, y_pred % 2
    for fn in (SCORES[name], getattr(sklearn.metrics, name)):
        with pytest.raises(ValueError, match=match):
            fn(y_true, y_pred, **kwargs)


@pytest.mark.parametrize("image_shape", [None, (1, 12, 20, 8)], ids=["as-is", "resized"])
def test_classification_dataset_matches_jax(image_shape):
    data, target = _volumes(3, shape=(2, 10, 16, 12))
    norm = functools.partial(jax_standardize, axis=(1, 2, 3))
    spatial = None if image_shape is None else image_shape[1:]
    jds = JaxClassificationDataset(data, target, norm, None, spatial)
    ds = ClassificationDataset(data, target, functools.partial(standardize, axis=(1, 2, 3)), None, spatial)
    assert len(ds) == len(jds) == 3
    for i in range(3):
        (x, y), (jx, jy) = ds[i], jds[i]
        assert x.dtype == np.float32 and y.dtype == np.int64 and int(y) == int(jy)
        np.testing.assert_allclose(x, jx, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="don't agree"):
        ClassificationDataset(data, target[:2], None, None, None)


@pytest.mark.parametrize("ndim", [2, 3])
def test_default_classification_loader(ndim):
    shape = (1, 24, 24) if ndim == 2 else (1, 8, 12, 12)
    data, target = _volumes(5, shape=shape)
    loader = default_classification_loader(data, target, batch_size=2, shuffle=True, seed=0)
    x, y = next(iter(loader))
    assert x.shape == (2,) + shape and x.dtype == torch.float32 and y.shape == (2,) and y.dtype == torch.int64
    assert len(loader) == 3
    with pytest.raises(ValueError, match="dimensionality"):
        default_classification_loader([np.zeros((1, 4))], [0], batch_size=1)


@pytest.fixture(scope="module")
def jax_variables():
    module = JaxResNet3dModule(**SMALL)
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, 16, 16, 16)))
    return module, _flat(variables["params"]), _flat(variables["batch_stats"])


def test_trainer_step_matches_jax(jax_variables, tmp_path):
    module, params, stats = jax_variables
    data, target = _volumes(2)
    x, y = np.stack(data).astype(np.float64), target
    with jax.enable_x64(True):
        as64 = functools.partial(jax.tree_util.tree_map, lambda v: jnp.asarray(v, jnp.float64))
        tree = lambda flat: unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})  # noqa: E731
        model = JaxModel(module.clone(dtype=jnp.float64), {}, (1, 1, 16, 16, 16), eager_init=False)
        model.variables = as64({"params": tree(params), "batch_stats": tree(stats)})
        jt = JaxClassificationTrainer(
            name="cls", train_loader=[(x, y)], val_loader=[(x, y)], model=model, loss=JaxCrossEntropyLoss(),
            metric=lambda a, b: 0.0, optimizer=JaxOptimizerSpec("sgd", lr=LR), device="cpu", mixed_precision=False,
            logger=None, save_root=str(tmp_path / "jax"))
        jt._initialize(1, None)
        variables, _, loss, _ = jt._train_step(jt.variables, jt.opt_state, jnp.asarray(x), jnp.asarray(y),
                                               jax.random.PRNGKey(1))
        expected = resnet3d_state_dict_from_jax_params(_flat(variables["params"]), _flat(variables["batch_stats"]))
        loss = float(loss)
    net = ResNet3dModule(**SMALL)
    net.load_state_dict(resnet3d_state_dict_from_jax_params(params, stats), strict=True)
    before = copy.deepcopy(net.state_dict())
    net = net.double()
    net.dtype = torch.float64
    trainer = ClassificationTrainer(
        name="cls", train_loader=[(x, y)], val_loader=[(x, y)], model=net, loss=CrossEntropyLoss(),
        metric=ClassificationMetric(), optimizer=port.OptimizerSpec("sgd", lr=LR), device="cpu",
        mixed_precision=False, logger=None, save_root=str(tmp_path / "port"))
    trainer._initialize(1, None)
    net.train()
    got_loss, pred = trainer._train_step(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got_loss), loss, rtol=1e-6)
    assert pred.shape == (2, 3)
    for name, value in net.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        change = float((expected[name].double() - before[name].double()).abs().max())
        err = float((value - expected[name].double()).abs().max())
        # the converter carries the JAX side's values in float32: one rounding step of them
        rounding = 2.0 ** -23 * float(expected[name].abs().max())
        assert err <= 1e-5 * change + rounding, (name, err, change)


class _Constant(torch.nn.Module):
    """Logits that the test sets: the argmax predictions of the validation."""

    def __init__(self, logits):
        super().__init__()
        self.logits = logits
        self.weight = torch.nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return self.logits[: x.shape[0]] + self.weight


def test_validation_scores_the_whole_set(tmp_path):
    """Predictions of all batches are scored at once: three batches of 2, 1 of 6 wrong."""
    logits = torch.tensor([[2.0, 0.0, 0.0], [0.0, 2.0, 0.0]])
    batches = [(np.zeros((2, 1, 4, 4, 4), np.float32), np.array(t)) for t in ([0, 1], [0, 1], [0, 2])]
    trainer = ClassificationTrainer(name="val", train_loader=batches, val_loader=batches, model=_Constant(logits),
                                    loss=CrossEntropyLoss(), metric=ClassificationMetric(),
                                    device="cpu", mixed_precision=False, save_root=str(tmp_path))
    assert trainer._validate() == pytest.approx(1 / 6)
    trainer.model.logits = torch.full((2, 3), float("nan"))
    with pytest.warns(UserWarning, match="NaN"):
        trainer._validate()


def test_fit_and_resume_with_resnet3d_18(tmp_path):
    """The default trainer on resnet3d_18: fit, rebuild from the checkpoint, resume; the
    ClassificationLogger writes its scalars and confusion matrices."""
    data, target = _volumes(6)
    train = default_classification_loader(data[:4], target[:4], batch_size=2, shuffle=True, seed=0)
    val = default_classification_loader(data[4:], target[4:], batch_size=2)
    model = port.resnet3d_18(1, 3, device="cpu", seed=1)
    trainer = default_classification_trainer("cls", model, train, val, device="cpu", mixed_precision=False,
                                             save_root=str(tmp_path), learning_rate=1e-3)
    assert isinstance(trainer, ClassificationTrainer) and trainer.logger_class is ClassificationLogger
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # matplotlib's and tensorboardX's own deprecations
        trainer.fit(iterations=4)
    assert trainer.iteration == 4 and os.path.isfile(os.path.join(trainer.checkpoint_folder, "best.ckpt"))
    assert any(f.startswith("events") for f in os.listdir(os.path.join(tmp_path, "logs", "cls")))
    rebuilt = port.DefaultTrainer.from_checkpoint(trainer.checkpoint_folder, "latest", device="cpu")
    assert type(rebuilt) is ClassificationTrainer and isinstance(rebuilt.metric, ClassificationMetric)
    assert all(torch.equal(v, trainer.model.state_dict()[k]) for k, v in rebuilt.model.state_dict().items())
    rebuilt.logger_class = None
    rebuilt.fit(iterations=2)
    assert rebuilt.iteration == 6 and 0.0 <= rebuilt.current_metric <= 1.0
