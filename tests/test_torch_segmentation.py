"""The port's decodings (``utils/segmentation.py``, ``ops/multicut.py``) against the JAX package's.

The same seeded label images, boundary maps, distance maps and noisy
affinities go through both packages; the labels must be equal, and the
multicut's edge features within 1e-6 (float32) and its costs equal.
"""

import numpy as np
import pytest
from scipy import ndimage

from test_metrics_decode import make_gt
from torch_em_tpu.ops import host as jax_host
from torch_em_tpu.ops import multicut as jax_multicut
from torch_em_tpu.transforms import PerObjectDistanceTransform
from torch_em_tpu.utils import segmentation as jax_segmentation
from torch_em_tpu_torch.ops import multicut
from torch_em_tpu_torch.utils import segmentation

OFFSETS_2D = [[-1, 0], [0, -1], [-9, 0], [0, -9]]
OFFSETS_3D = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [-2, 0, 0], [0, -5, 0], [0, 0, -5]]


def _volume_gt(seed=0, shape=(6, 40, 44), n=14):
    """Instance labels of a small volume: the nearest of ``n`` seeded points (Voronoi cells)."""
    rng = np.random.default_rng(seed)
    seeds = np.zeros(shape, dtype="uint32")
    seeds[tuple(rng.integers(0, s, n) for s in shape)] = np.arange(1, n + 1)
    indices = ndimage.distance_transform_edt(seeds == 0, return_distances=False, return_indices=True)
    return seeds[tuple(indices)]


def _noisy_disaffinities(gt, offsets, seed=0, noise=0.15):
    affs, _ = jax_host.compute_affinities(gt.astype("uint64"), offsets)
    rng = np.random.default_rng(seed)
    return np.clip(1 - affs + noise * rng.normal(size=affs.shape), 0, 1).astype("float32")


def _boundaries(gt, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    b = jax_host.find_boundaries(gt).astype("float32")
    return np.clip(b + noise * rng.random(gt.shape, dtype=np.float32), 0, 1).astype("float32")


def _equal(got, expected):
    got, expected = np.asarray(got), np.asarray(expected)
    assert got.shape == expected.shape and got.dtype == expected.dtype, (got.dtype, expected.dtype)
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("hmap,with_background", [(False, False), (True, False), (True, True)])
def test_size_filter(hmap, with_background):
    gt = make_gt(shape=(60, 60)).astype("uint32")
    rng = np.random.default_rng(1)
    noisy = gt.copy()
    speckle = rng.random(gt.shape) < 0.02
    noisy[speckle] = 50 + rng.integers(0, 30, size=int(speckle.sum()))  # small segments
    noisy[:3, :3] = 0
    h = rng.random(gt.shape, dtype=np.float32) if hmap else None
    kwargs = dict(min_size=30, hmap=h, with_background=with_background)
    got = segmentation.size_filter(noisy, **kwargs)
    _equal(got, jax_segmentation.size_filter(noisy, **kwargs))
    assert len(np.unique(got)) < len(np.unique(noisy))


@pytest.mark.parametrize("case", ["2d-default-strides", "2d-strides-1", "3d-default-strides", "3d-masked"])
def test_mutex_watershed_segmentation(case):
    if case.startswith("2d"):
        gt, offsets = make_gt(shape=(64, 64)), OFFSETS_2D
    else:
        gt, offsets = _volume_gt(), OFFSETS_3D
    affs = _noisy_disaffinities(gt, offsets)
    fg = np.ones(gt.shape, dtype="float32")
    if case == "3d-masked":
        fg[:, :10] = 0.2
    kwargs = dict(offsets=offsets, min_size=10, strides=[1, 1] if case == "2d-strides-1" else None)
    got = segmentation.mutex_watershed_segmentation(fg, affs, **kwargs)
    _equal(got, jax_segmentation.mutex_watershed_segmentation(fg, affs, **kwargs))
    assert len(np.unique(got)) > 3


def test_mutex_watershed_segmentation_is_deterministic():
    gt = _volume_gt(seed=1)
    affs = _noisy_disaffinities(gt, OFFSETS_3D, seed=2)
    fg = np.ones(gt.shape, dtype="float32")
    first = segmentation.mutex_watershed_segmentation(fg, affs, OFFSETS_3D)
    _equal(segmentation.mutex_watershed_segmentation(fg, affs, OFFSETS_3D), first)


@pytest.mark.parametrize("ndim", [2, 3])
def test_watershed_decodings(ndim):
    gt = make_gt(shape=(64, 64)) if ndim == 2 else _volume_gt()
    boundaries = _boundaries(gt)
    fg = np.ones(gt.shape, dtype="float32")
    fg[(slice(0, 3),) * ndim] = 0
    _equal(segmentation.connected_components_with_boundaries(fg, boundaries),
           jax_segmentation.connected_components_with_boundaries(fg, boundaries))
    _equal(segmentation.watershed_from_components(boundaries, fg, min_size=5),
           jax_segmentation.watershed_from_components(boundaries, fg, min_size=5))
    _equal(segmentation.watershed_from_maxima(boundaries, fg, min_distance=3, min_size=5),
           jax_segmentation.watershed_from_maxima(boundaries, fg, min_distance=3, min_size=5))


@pytest.mark.parametrize("min_size", [0, 5])
def test_watershed_from_center_and_boundary_distances(min_size):
    gt = make_gt(shape=(64, 64))
    target = PerObjectDistanceTransform(apply_label=False)(gt)
    fg, center, boundary = target[0], target[1], target[2]
    got, got_debug = segmentation.watershed_from_center_and_boundary_distances(
        center, boundary, fg, min_size=min_size, debug=True)
    expected, expected_debug = jax_segmentation.watershed_from_center_and_boundary_distances(
        center, boundary, fg, min_size=min_size, debug=True)
    _equal(got, expected)
    assert sorted(got_debug) == sorted(expected_debug)
    for key in expected_debug:
        np.testing.assert_array_equal(got_debug[key], expected_debug[key], err_msg=key)
    assert len(np.unique(got)) > 2


@pytest.mark.parametrize("case", ["2d", "3d", "3d-anisotropic"])
def test_multicut_segmentation(case):
    gt = make_gt(shape=(64, 64)) if case == "2d" else _volume_gt(shape=(4, 40, 44))
    boundaries = _boundaries(gt)
    kwargs = dict(anisotropic=case == "3d-anisotropic")
    got = multicut.multicut_segmentation(boundaries, **kwargs)
    _equal(got, jax_multicut.multicut_segmentation(boundaries, **kwargs))
    assert len(np.unique(got)) > 2


def test_multicut_pieces():
    gt = make_gt(shape=(64, 64))
    boundaries = _boundaries(gt)
    ws, max_id = multicut.distance_transform_watershed(boundaries, min_size=4)
    ws_jax, max_id_jax = jax_multicut.distance_transform_watershed(boundaries, min_size=4)
    _equal(ws, ws_jax)
    assert max_id == max_id_jax
    edges = multicut.compute_rag(ws)
    _equal(edges, jax_multicut.compute_rag(ws))
    feats, lengths = multicut.compute_boundary_mean_and_length(ws, boundaries, edges)
    feats_jax, lengths_jax = jax_multicut.compute_boundary_mean_and_length(ws, boundaries, edges)
    np.testing.assert_allclose(feats, feats_jax, rtol=0, atol=1e-6)
    _equal(lengths, lengths_jax)
    weighting = lengths / lengths.max()
    costs = multicut.compute_edge_costs(feats, beta=0.4, weighting=weighting)
    _equal(costs, jax_multicut.compute_edge_costs(feats, beta=0.4, weighting=weighting))
    _equal(multicut.multicut_gaec(max_id + 1, edges, costs), jax_multicut.multicut_gaec(max_id + 1, edges, costs))
    stacked, n = multicut.stacked_watershed(np.stack([boundaries] * 3))
    stacked_jax, n_jax = jax_multicut.stacked_watershed(np.stack([boundaries] * 3))
    _equal(stacked, stacked_jax)
    assert n == n_jax
