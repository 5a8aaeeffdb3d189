"""The port's label ops and transforms against the JAX package's.

Seeded instance-label volumes (2D and 3D, with and without an ignore label)
go through ``ops/host.py``, ``transforms/label.py`` and ``ops/device.py`` of
both packages. Integer and boolean outputs must be equal; float distances
agree within 1e-6; the device ops equal both the JAX device ops and the
port's host transforms exactly.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from torch_em_tpu.ops import device as jax_device
from torch_em_tpu.ops import host as jax_host
from torch_em_tpu.transforms import label as jax_label
from torch_em_tpu_torch.ops import device, host
from torch_em_tpu_torch.transforms import label
from torch_em_tpu_torch.trainer.serialization import deserialize_value, serialize_value

SHAPES = {"2d": (40, 44), "3d": (8, 24, 28)}
OFFSETS = {"2d": [[-1, 0], [0, -1], [-3, 0], [0, 5]],
           "3d": [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [-2, 0, 0], [0, 4, -3]]}
IGNORE = -1


def _labels(ndim, seed=0, ignore=False):
    """Instance labels: connected blobs of smoothed noise, ids shuffled, some background;
    with ``ignore``, a corner of the ignore label."""
    rng = np.random.default_rng(seed)
    shape = SHAPES[ndim]
    blobs = ndimage.gaussian_filter(rng.normal(size=shape), 2.0) > 0
    seg, n = ndimage.label(blobs)
    ids = np.concatenate([[0], rng.permutation(np.arange(1, n + 1)) + 3])
    seg = ids[seg].astype(np.int64)
    if ignore:
        seg[(slice(0, shape[0] // 3),) * len(shape)] = IGNORE
    return seg


def _assert_same(got, expected, path="out"):
    if isinstance(expected, dict):
        assert sorted(got) == sorted(expected), path
        for k in expected:
            _assert_same(got[k], expected[k], f"{path}[{k!r}]")
    elif isinstance(expected, (tuple, list)):
        assert type(got) is type(expected) and len(got) == len(expected), path
        for i, (g, e) in enumerate(zip(got, expected)):
            _assert_same(g, e, f"{path}[{i}]")
    elif isinstance(expected, (slice, int, float, np.generic)) and not isinstance(expected, np.floating):
        assert got == expected, path
    else:
        got, expected = np.asarray(got), np.asarray(expected)
        assert got.shape == expected.shape and got.dtype == expected.dtype, (path, got.dtype, expected.dtype)
        if np.issubdtype(expected.dtype, np.floating):
            np.testing.assert_allclose(got, expected, rtol=0, atol=1e-6, err_msg=path)
        else:
            np.testing.assert_array_equal(got, expected, err_msg=path)


def _image(ndim, seed=1):
    return ndimage.gaussian_filter(np.random.default_rng(seed).random(SHAPES[ndim]), 1.5).astype(np.float32)


# host op -> (args for a 2d or 3d input, kwargs)
HOST_CASES = {
    "connected_components": lambda nd: ((_labels(nd) != 0,), {}),
    "connected_components_full": lambda nd: ((_labels(nd) != 0,), dict(connectivity=2)),
    "connected_components_per_id": lambda nd: ((_labels(nd) % 3,), dict(with_background=False)),
    "find_boundaries_thick": lambda nd: ((_labels(nd),), dict(mode="thick")),
    "find_boundaries_inner": lambda nd: ((_labels(nd),), dict(mode="inner")),
    "find_boundaries_outer": lambda nd: ((_labels(nd),), dict(mode="outer")),
    "find_boundaries_diagonal": lambda nd: ((_labels(nd),), dict(mode="thick", connectivity=3)),
    "relabel_consecutive": lambda nd: ((_labels(nd),), dict(start_label=2)),
    "label_consecutive": lambda nd: ((_labels(nd),), {}),
    "size_filter": lambda nd: ((_labels(nd),), dict(min_size=20)),
    "distance_transform": lambda nd: ((_labels(nd) == 0,), {}),
    "distance_transform_sampled": lambda nd: ((_labels(nd) == 0,), dict(sampling=(2.0,) + (1.0,) * (len(SHAPES[nd]) - 1))),
    "vector_distance_transform": lambda nd: ((_labels(nd) != 0,), dict(sampling=(1.5,) + (1.0,) * (len(SHAPES[nd]) - 1))),
    "peak_local_max": lambda nd: ((_image(nd),), dict(min_distance=2, threshold_abs=0.45)),
    "resize_linear": lambda nd: ((_image(nd), tuple(s // 2 + 3 for s in SHAPES[nd])), {}),
    "resize_nearest": lambda nd: ((_labels(nd), tuple(s * 2 - 1 for s in SHAPES[nd])), dict(order=0)),
    "region_bounding_boxes": lambda nd: ((_labels(nd),), {}),
    "region_centroids": lambda nd: ((_labels(nd),), {}),
    "region_sizes": lambda nd: ((_labels(nd),), {}),
    "binary_erosion": lambda nd: ((_labels(nd) != 0,), dict(iterations=2)),
    "binary_dilation": lambda nd: ((_labels(nd) != 0,), dict(iterations=2)),
    "compute_affinities": lambda nd: ((_labels(nd), OFFSETS[nd]), {}),
    "compute_affinities_ignore": lambda nd: ((_labels(nd, ignore=True), OFFSETS[nd]),
                                             dict(have_ignore_label=True, ignore_label=IGNORE)),
}


@pytest.mark.parametrize("ndim", sorted(SHAPES))
@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_op_matches_jax(case, ndim):
    name = next(n for n in host.__all__ if case == n or case.startswith(n + "_"))
    args, kwargs = HOST_CASES[case](ndim)
    _assert_same(getattr(host, name)(*args, **kwargs), getattr(jax_host, name)(*args, **kwargs))


def test_host_ops_cover_the_module():
    assert sorted(host.__all__) == sorted(jax_host.__all__)
    covered = {n for n in host.__all__ for c in HOST_CASES if c == n or c.startswith(n + "_")}
    assert covered == set(host.__all__)


# transform -> (constructor kwargs for 2d / 3d, whether its input has the ignore label)
TRANSFORMS = {
    "MinSizeLabelTransform": (lambda nd: dict(min_size=15), False),
    "MinSizeLabelTransform_ensure_zero": (lambda nd: dict(ensure_zero=True, ndim=len(SHAPES[nd])), False),
    "BoundaryTransform": (lambda nd: dict(), False),
    "BoundaryTransform_binary_inner": (lambda nd: dict(mode="inner", add_binary_target=True), False),
    "NoToBackgroundBoundaryTransform": (lambda nd: dict(add_binary_target=True), False),
    "NoToBackgroundBoundaryTransform_outer": (lambda nd: dict(mode="outer"), False),
    "BoundaryTransformWithIgnoreLabel": (lambda nd: dict(ignore_label=IGNORE), True),
    "BoundaryTransformWithIgnoreLabel_binary": (
        lambda nd: dict(ignore_label=IGNORE, add_binary_target=True), True),
    "AffinityTransform": (lambda nd: dict(offsets=OFFSETS[nd]), False),
    "AffinityTransform_binary_mask": (
        lambda nd: dict(offsets=OFFSETS[nd], add_binary_target=True, add_mask=True), False),
    "AffinityTransform_ignore": (
        lambda nd: dict(offsets=OFFSETS[nd], ignore_label=IGNORE, add_mask=True), True),
    "AffinityTransform_ignore_transitions": (
        lambda nd: dict(offsets=OFFSETS[nd], ignore_label=IGNORE, add_binary_target=True, add_mask=True,
                        include_ignore_transitions=True), True),
    "OneHotTransform": (lambda nd: dict(class_ids=4), False),
    "OneHotTransform_unique": (lambda nd: dict(), False),
    "DistanceTransform": (lambda nd: dict(), False),
    "DistanceTransform_directed": (
        lambda nd: dict(directed_distances=True, max_distance=5.0, invert=True), False),
    "DistanceTransform_empty": (lambda nd: dict(foreground_id=99), False),
    "PerObjectDistanceTransform": (lambda nd: dict(), False),
    "PerObjectDistanceTransform_all": (
        lambda nd: dict(directed_distances=True, instances=True, min_size=10, apply_label=False), False),
}


@pytest.mark.parametrize("ndim", sorted(SHAPES))
@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_transform_matches_jax(case, ndim):
    name = case.split("_")[0]
    make_kwargs, ignore = TRANSFORMS[case]
    labels = _labels(ndim, seed=2, ignore=ignore)
    if name == "OneHotTransform":
        labels = labels % 4
    if name == "DistanceTransform":
        labels = (labels != 0).astype(np.int64)
    ours, theirs = getattr(label, name)(**make_kwargs(ndim)), getattr(jax_label, name)(**make_kwargs(ndim))
    assert ours.init_kwargs == theirs.init_kwargs
    _assert_same(ours(labels.copy()), theirs(labels.copy()))
    rebuilt = deserialize_value(serialize_value(ours))
    assert type(rebuilt) is type(ours) and rebuilt.init_kwargs == ours.init_kwargs


@pytest.mark.parametrize("ndim", sorted(SHAPES))
def test_label_functions_match_jax(ndim):
    labels = _labels(ndim, seed=3)
    _assert_same(label.connected_components(labels), jax_label.connected_components(labels))
    _assert_same(label.connected_components(labels[None], ndim=len(SHAPES[ndim]), ensure_zero=True),
                 jax_label.connected_components(labels[None], ndim=len(SHAPES[ndim]), ensure_zero=True))
    _assert_same(label.labels_to_binary(labels, 5), jax_label.labels_to_binary(labels, 5))
    for with_background in (True, False):
        _assert_same(label.label_consecutive(labels, with_background),
                     jax_label.label_consecutive(labels, with_background))


def _batch(ndim, dtype, ignore=False):
    labels = np.stack([_labels(ndim, seed=s, ignore=ignore) for s in (4, 5)])[:, None]
    if ignore:
        return labels
    labels = host.connected_components(labels) if dtype == "uint32" else labels
    return labels.astype(dtype)


DEVICE_CASES = {
    "affinities": (dict(), False),
    "affinities_binary_mask": (dict(add_binary_target=True, add_mask=True), False),
    "affinities_ignore": (dict(ignore_label=IGNORE, add_mask=True), True),
    "affinities_ignore_binary_mask": (dict(ignore_label=IGNORE, add_binary_target=True, add_mask=True), True),
}


@pytest.mark.parametrize("ndim", sorted(SHAPES))
@pytest.mark.parametrize("case,dtype", [(c, d) for c in sorted(DEVICE_CASES) for d in
                                        (["int64"] if DEVICE_CASES[c][1] else ["int64", "uint32", "float32"])])
def test_device_affinities_match_jax_and_host(case, dtype, ndim):
    """Labels as the loader gives them: int64, the uint32 of connected_components, or
    float32 (``label_dtype``); an ignore label of -1 needs signed labels."""
    kwargs, ignore = DEVICE_CASES[case]
    y = _batch(ndim, dtype, ignore)
    offsets = OFFSETS[ndim]
    transform = device.DeviceAffinityTransform(offsets, **kwargs)
    got = transform(torch.from_numpy(y))
    assert got.dtype == torch.float32
    expected = np.asarray(jax_device.DeviceAffinityTransform(offsets, **kwargs)(y))
    np.testing.assert_array_equal(got.numpy(), expected)
    host_transform = label.AffinityTransform(offsets, **kwargs)
    for g, sample in zip(got.numpy(), y):
        np.testing.assert_array_equal(g, host_transform(sample[0]))
    assert transform.init_kwargs == jax_device.DeviceAffinityTransform(offsets, **kwargs).init_kwargs


@pytest.mark.parametrize("dtype", ["int64", "uint32", "float32"])
@pytest.mark.parametrize("ndim", sorted(SHAPES))
@pytest.mark.parametrize("add_binary_target", [False, True])
def test_device_boundaries_match_jax_and_host(add_binary_target, ndim, dtype):
    y = _batch(ndim, dtype)
    transform = device.DeviceBoundaryTransform(add_binary_target=add_binary_target)
    got = transform(torch.from_numpy(y))
    expected = np.asarray(jax_device.DeviceBoundaryTransform(add_binary_target=add_binary_target)(y))
    np.testing.assert_array_equal(got.numpy(), expected)
    host_transform = label.BoundaryTransform(add_binary_target=add_binary_target)
    for g, sample in zip(got.numpy(), y):
        np.testing.assert_array_equal(g, host_transform(sample[0]).astype(np.float32))


@pytest.mark.parametrize("ndim", sorted(SHAPES))
def test_compute_affinities_batched_matches_jax(ndim):
    y = _batch(ndim, "int64", ignore=True)[:, 0]
    offsets = OFFSETS[ndim] + [[100] + [0] * (len(SHAPES[ndim]) - 1)]  # one offset leaves the volume
    for have_ignore in (False, True):
        got = device.compute_affinities_batched(torch.from_numpy(y), offsets, have_ignore, IGNORE)
        expected = jax_device.compute_affinities_batched(y, offsets, have_ignore, IGNORE)
        for g, e in zip(got, expected):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))
