"""The port's metrics (``metric/``) against the JAX package's.

The evaluation measures of ``metric/eval.py`` run in float64 on both sides
and must agree to 1e-12 on the same seeded label images; every metric class
(mutex watershed on affinities and on embeddings, multicut, HDBSCAN) must
give the same score within 1e-12 on the same predictions and targets; the
clDice metric's skeletons are equal and its scores agree to 1e-6 (its soft
skeleton is float32 on both sides).
"""

import numpy as np
import pytest
import torch

from test_metrics_decode import make_gt
from torch_em_tpu import metric as jax_metric
from torch_em_tpu.metric import cldice as jax_cldice
from torch_em_tpu.ops import host as jax_host
from torch_em_tpu_torch import metric
from torch_em_tpu_torch.metric import cldice

OFFSETS = [[-1, 0], [0, -1], [-9, 0], [0, -9]]
TOL = 1e-12


def _pairs():
    """(seg, gt) pairs: a perturbed GT (merges, splits, speckle, some background), the
    GT against itself permuted, and background-only sides."""
    gt = make_gt(shape=(60, 60)).astype("uint32")
    rng = np.random.default_rng(0)
    seg = gt.copy()
    seg[:20] = 1  # a merge
    seg[40:, 30:] = 99  # a split off
    speckle = rng.random(gt.shape) < 0.03
    seg[speckle] = rng.integers(0, 12, size=int(speckle.sum()))
    gt_bg = gt.copy()
    gt_bg[gt_bg == 2] = 0
    perm = np.concatenate([[0], rng.permutation(int(gt.max())) + 1]).astype("uint32")
    return {"perturbed": (seg, gt), "perturbed-gt-background": (seg, gt_bg), "permuted": (perm[gt], gt),
            "empty-seg": (np.zeros_like(gt), gt), "empty-gt": (seg, np.zeros_like(gt))}


def _close(got, expected):
    if isinstance(expected, dict):
        assert sorted(got) == sorted(expected)
        for key in expected:
            _close(got[key], expected[key])
    elif isinstance(expected, tuple):
        assert len(got) == len(expected)
        for g, e in zip(got, expected):
            _close(g, e)
    else:
        assert type(got) is type(expected), (type(got), type(expected))
        assert abs(got - expected) <= TOL, (got, expected)


@pytest.mark.parametrize("pair", list(_pairs()))
def test_eval_measures(pair):
    seg, gt = _pairs()[pair]
    table = metric.contingency_table(seg, gt)
    np.testing.assert_array_equal(table.toarray(), jax_metric.contingency_table(seg, gt).toarray())
    for threshold in (0.3, 0.5, 0.75):
        _close(metric.matching(seg, gt, threshold=threshold), jax_metric.matching(seg, gt, threshold=threshold))
    _close(metric.variation_of_information(seg, gt), jax_metric.variation_of_information(seg, gt))
    _close(metric.variation_of_information(seg, gt, ignore_seg=[0], ignore_gt=[0]),
           jax_metric.variation_of_information(seg, gt, ignore_seg=[0], ignore_gt=[0]))
    _close(metric.rand_index(seg, gt), jax_metric.rand_index(seg, gt))
    _close(metric.symmetric_best_dice_score(seg, gt), jax_metric.symmetric_best_dice_score(seg, gt))


def _affinity_inputs(with_background, noise=0.2):
    """A batch of 2: noisy disaffinities of two GTs (a foreground channel first with
    ``with_background``) and the GT as the last target channel."""
    preds, targets = [], []
    for seed in (42, 7):
        gt = make_gt(shape=(64, 64), seed=seed)
        affs, _ = jax_host.compute_affinities(gt.astype("uint64"), OFFSETS)
        rng = np.random.default_rng(seed)
        affs = np.clip(1 - affs + noise * rng.normal(size=affs.shape), 0, 1)
        if with_background:
            fg = (rng.random((1,) + gt.shape) > 0.05).astype("float64")
            affs = np.concatenate([fg, affs])
        preds.append(affs.astype("float32"))
        targets.append(np.stack([np.zeros(gt.shape), gt]).astype("float32"))
    return np.stack(preds), np.stack(targets)


def _embedding_inputs(noise=0.3):
    preds, targets = [], []
    for seed in (42, 7):
        gt = make_gt(shape=(48, 48), seed=seed)
        rng = np.random.default_rng(seed)
        centers = rng.normal(size=(int(gt.max()) + 1, 4)) * 2
        emb = centers[gt].transpose(2, 0, 1) + noise * rng.normal(size=(4,) + gt.shape)
        preds.append(emb.astype("float32"))
        targets.append(gt[None].astype("float32"))
    return np.stack(preds), np.stack(targets)


MWS_CLASSES = ["MWSIOUMetric", "MWSSBDMetric", "MWSVOIMetric", "MWSRandMetric"]
EMBEDDING_CLASSES = ["EmbeddingMWSIOUMetric", "EmbeddingMWSSBDMetric", "EmbeddingMWSVOIMetric",
                     "EmbeddingMWSRandMetric"]


@pytest.mark.parametrize("name", MWS_CLASSES)
@pytest.mark.parametrize("strides", [None, [1, 1]])
def test_mws_metrics(name, strides):
    kwargs = dict(offsets=OFFSETS, min_seg_size=5, strides=strides)
    ours, theirs = getattr(metric, name)(**kwargs), getattr(jax_metric, name)(**kwargs)
    assert ours.init_kwargs == theirs.init_kwargs and ours.host_metric
    pred, target = _affinity_inputs(with_background=isinstance(ours.segmenter, metric.MWS)
                                    and ours.segmenter.with_background)
    score = ours(pred, target)
    _close(score, theirs(pred, target))
    # tensors, as a caller on the card would hand them over, give the same score
    _close(ours(torch.from_numpy(pred).to(torch.bfloat16).float(), torch.from_numpy(target)),
           theirs(torch.from_numpy(pred).to(torch.bfloat16).float().numpy(), target))


@pytest.mark.parametrize("name", EMBEDDING_CLASSES)
def test_embedding_mws_metrics(name):
    kwargs = dict(delta=1.0, offsets=OFFSETS, min_seg_size=5)
    pred, target = _embedding_inputs()
    _close(getattr(metric, name)(**kwargs)(pred, target), getattr(jax_metric, name)(**kwargs)(pred, target))


def test_embeddings_to_affinities():
    pred, _ = _embedding_inputs()
    offsets = OFFSETS + [[2, -3], [70, 0]]  # one past the image, which keeps its default
    got = metric.embeddings_to_affinities(pred[0], offsets, delta=1.5)
    expected = jax_metric.instance_segmentation_metric.embeddings_to_affinities(pred[0], offsets, delta=1.5)
    assert got.dtype == expected.dtype
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("name", ["MulticutVOIMetric", "MulticutRandMetric"])
@pytest.mark.parametrize("anisotropic", [False, True])
def test_multicut_metrics(name, anisotropic):
    preds, targets = [], []
    for seed in (42, 7):
        gt = make_gt(shape=(64, 64), seed=seed)
        rng = np.random.default_rng(seed)
        b = jax_host.find_boundaries(gt).astype("float32") + 0.1 * rng.random(gt.shape, dtype=np.float32)
        stack = np.stack([b, b[::-1]]) if anisotropic else b
        preds.append(stack[None])
        targets.append(np.stack([gt, gt[::-1]])[None] if anisotropic else gt[None])
    pred, target = np.stack(preds), np.stack(targets).astype("float32")
    kwargs = dict(min_seg_size=5, anisotropic=anisotropic)
    _close(getattr(metric, name)(**kwargs)(pred, target), getattr(jax_metric, name)(**kwargs)(pred, target))


@pytest.mark.parametrize("name", ["HDBScanIOUMetric", "HDBScanSBDMetric", "HDBScanRandMetric", "HDBScanVOIMetric"])
def test_hdbscan_metrics(name):
    pred, target = _embedding_inputs()
    pred, target = pred[:, :, ::3, ::3].copy(), target[:, :, ::3, ::3].copy()  # HDBSCAN is quadratic
    kwargs = dict(min_size=5, eps=0.2)
    _close(getattr(metric, name)(**kwargs)(pred, target), getattr(jax_metric, name)(**kwargs)(pred, target))


def test_cldice():
    rng = np.random.default_rng(0)
    mask = np.zeros((40, 40), dtype="float32")
    mask[10:16, 4:36] = 1
    mask[4:36, 20:24] = 1
    other = np.clip(mask + (rng.random(mask.shape) > 0.97), 0, 1).astype("float32")
    np.testing.assert_array_equal(cldice.skeletonize(mask), jax_cldice.skeletonize(mask))
    for method in ("skimage", "soft"):
        got = metric.clDice(other, mask, skeletonize_method=method)
        expected = jax_metric.clDice(other, mask, skeletonize_method=method)
        assert abs(got - expected) <= 1e-6, (method, got, expected)
    volume = np.stack([mask, other, mask])
    assert abs(metric.clDice(volume, volume[::-1].copy()) - jax_metric.clDice(volume, volume[::-1].copy())) <= 1e-6
    with pytest.raises(ValueError):
        metric.clDice(mask, mask, skeletonize_method="other")
