"""ctypes bindings for the native (C++) host ops: watershed, mutex watershed,
connected components, HDBSCAN and random forests.

The port's own copy of the JAX package's ``ops/native``. ``tem_native.cpp``
beside this file is built with ``g++ -O3 -std=c++17 -fPIC -shared`` at first
use into ``torch_em_tpu_torch/_build/tem_native-<hash>/``, keyed by a hash of
the source and the flags (``ops/_build.py:compile_library``). A failed build
raises; nothing falls back to another implementation. ``is_available()``
answers whether the library builds and loads here; no path of the port asks it
to choose another implementation. ``hdbscan.cpp`` is a library of its own,
``_build/tem_hdbscan-<hash>/``, built the same way with ``-pthread`` and
``-ffp-contract=off`` (no fused multiply-add may change a distance's rounding).
``forest.cpp`` (the trees of ``shallow2deep.forest.fit_forest``) is another,
``_build/tem_forest-<hash>/``, built with the same flags.
"""

import ctypes
import functools
import shutil
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from .._build import compile_library

__all__ = ["watershed", "mutex_watershed", "connected_components_labels", "hdbscan", "hdbscan_mst",
           "hdbscan_labels", "load_library", "load_hdbscan_library", "load_forest_library", "is_available"]

SOURCE = Path(__file__).resolve().parent / "tem_native.cpp"
HDBSCAN_SOURCE = Path(__file__).resolve().parent / "hdbscan.cpp"
FOREST_SOURCE = Path(__file__).resolve().parent / "forest.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
HDBSCAN_FLAGS = GXX_FLAGS + ("-pthread", "-ffp-contract=off")
MAX_NDIM = 8  # the C++ side keeps per-axis strides in arrays of 8


def _find_gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ was not found on PATH; it builds the port's native host ops")
    return found


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build ``tem_native.cpp`` (once per content hash) and load it with its signatures."""
    lib = ctypes.CDLL(str(compile_library("tem_native", _find_gxx, GXX_FLAGS, [SOURCE])))
    f32, u32, i64 = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_uint32, ctypes.c_int64))
    lib.watershed.argtypes = [f32, u32, ctypes.c_void_p, i64, ctypes.c_int]
    lib.mutex_watershed.argtypes = [f32, i64, ctypes.c_int, i64, ctypes.c_int, i64, ctypes.c_int,
                                    ctypes.c_uint64, ctypes.c_void_p, u32]
    lib.connected_components_labels.argtypes = [u32, i64, ctypes.c_int, u32]
    for fn in (lib.watershed, lib.mutex_watershed, lib.connected_components_labels):
        fn.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def load_hdbscan_library() -> ctypes.CDLL:
    """Build ``hdbscan.cpp`` (once per content hash) and load it with its signatures."""
    lib = ctypes.CDLL(str(compile_library("tem_hdbscan", _find_gxx, HDBSCAN_FLAGS, [HDBSCAN_SOURCE])))
    f64, i64 = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    lib.tem_hdbscan_mst.argtypes = [f64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, i64, i64, f64]
    lib.tem_hdbscan_labels.argtypes = [i64, i64, f64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, i64]
    for fn in (lib.tem_hdbscan_mst, lib.tem_hdbscan_labels):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_forest_library() -> ctypes.CDLL:
    """Build ``forest.cpp`` (once per content hash) and load it with its signatures."""
    lib = ctypes.CDLL(str(compile_library("tem_forest", _find_gxx, HDBSCAN_FLAGS, [FOREST_SOURCE])))
    f32, f64, i32, i64 = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_double, ctypes.c_int32, ctypes.c_int64))
    i8, u8, u32 = (ctypes.POINTER(t) for t in (ctypes.c_int8, ctypes.c_uint8, ctypes.c_uint32))
    lib.tem_forest_fit.argtypes = [f32, i32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f64,
                                   ctypes.c_int64, f64, u32, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_int64, ctypes.c_double,
                                   i8, ctypes.c_int]
    lib.tem_forest_fit.restype = ctypes.c_void_p
    lib.tem_forest_sizes.argtypes = [ctypes.c_void_p, i64]
    lib.tem_forest_copy.argtypes = [ctypes.c_void_p, ctypes.c_int64, i64, f64, i64, i64, f64, f64, i64, f64, u8]
    lib.tem_forest_free.argtypes = [ctypes.c_void_p]
    for fn in (lib.tem_forest_sizes, lib.tem_forest_copy, lib.tem_forest_free):
        fn.restype = None
    return lib


def is_available() -> bool:
    """Whether ``load_library()`` builds and loads the native library (a query: a failed build
    raises again at the next call of an op)."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _shape(shape) -> np.ndarray:
    if not 1 <= len(shape) <= MAX_NDIM or min(shape) < 1:
        raise ValueError(f"the native ops take 1 to {MAX_NDIM} non-empty axes, got shape {tuple(shape)}")
    return np.asarray(shape, dtype="int64")


def _mask(mask: Optional[np.ndarray], shape):
    """A uint8 copy of ``mask`` (None stays None), checked against ``shape``."""
    if mask is None:
        return None
    mask = np.ascontiguousarray(mask, dtype="uint8")
    if mask.shape != tuple(shape):
        raise ValueError(f"mask of shape {mask.shape} for data of shape {tuple(shape)}")
    return mask


def _mask_ptr(mask: Optional[np.ndarray]):
    return None if mask is None else mask.ctypes.data_as(ctypes.c_void_p)


def watershed(hmap: np.ndarray, seeds: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Seeded watershed via priority flood (skimage.watershed functional spec).

    Args:
        hmap: Height map (float).
        seeds: Seed labels (nonzero = seed); not modified.
        mask: Optional boolean mask restricting the flood.

    Returns:
        The labels grown from the seeds.
    """
    lib = load_library()
    hmap = np.ascontiguousarray(hmap, dtype="float32")
    labels = np.array(seeds, dtype="uint32", order="C", copy=True)
    if labels.shape != hmap.shape:
        raise ValueError(f"seeds of shape {labels.shape} for a height map of shape {hmap.shape}")
    shape = _shape(hmap.shape)
    mask = _mask(mask, hmap.shape)
    lib.watershed(_ptr(hmap, ctypes.c_float), _ptr(labels, ctypes.c_uint32), _mask_ptr(mask),
                  _ptr(shape, ctypes.c_int64), hmap.ndim)
    return labels


def mutex_watershed(
    affinities: np.ndarray,
    offsets: List[List[int]],
    strides: Optional[Sequence[int]] = None,
    randomize_strides: bool = False,
    mask: Optional[np.ndarray] = None,
    seed: int = 0,
) -> np.ndarray:
    """Mutex watershed segmentation (elf.segmentation.mutex_watershed spec).

    ``affinities`` follow the training (disaffinity) convention: 1 = boundary.
    The first ndim offsets are attractive, the rest repulsive; strides
    subsample repulsive edges (at random with ``randomize_strides``, from the
    generator seeded with ``seed``).
    """
    lib = load_library()
    affinities = np.ascontiguousarray(affinities, dtype="float32")
    n_offsets, spatial = affinities.shape[0], affinities.shape[1:]
    ndim = len(spatial)
    offsets_arr = np.ascontiguousarray(np.asarray(offsets, dtype="int64"))
    if offsets_arr.shape != (n_offsets, ndim):
        raise ValueError(f"{n_offsets} affinity channels of {ndim} axes need offsets of shape "
                         f"({n_offsets}, {ndim}), got {offsets_arr.shape}")
    strides_arr = np.ascontiguousarray(np.asarray([1] * ndim if strides is None else strides, dtype="int64"))
    if strides_arr.shape != (ndim,) or (strides_arr < 1).any():
        raise ValueError(f"strides {strides} for {ndim} axes")
    shape = _shape(spatial)
    mask = _mask(mask, spatial)
    out = np.zeros(spatial, dtype="uint32")
    lib.mutex_watershed(
        _ptr(affinities, ctypes.c_float), _ptr(offsets_arr, ctypes.c_int64), n_offsets,
        _ptr(shape, ctypes.c_int64), ndim, _ptr(strides_arr, ctypes.c_int64),
        int(randomize_strides), seed, _mask_ptr(mask), _ptr(out, ctypes.c_uint32),
    )
    return out


def connected_components_labels(seg: np.ndarray) -> np.ndarray:
    """Connected components of a label image (same id + adjacency)."""
    lib = load_library()
    seg = np.ascontiguousarray(seg, dtype="uint32")
    shape = _shape(seg.shape)
    out = np.zeros(seg.shape, dtype="uint32")
    lib.connected_components_labels(_ptr(seg, ctypes.c_uint32), _ptr(shape, ctypes.c_int64), seg.ndim,
                                    _ptr(out, ctypes.c_uint32))
    return out


def _check_clustering(min_cluster_size, cluster_selection_epsilon):
    if not isinstance(min_cluster_size, (int, np.integer)) or min_cluster_size < 2:
        raise ValueError(f"min_cluster_size must be an integer of at least 2, got {min_cluster_size!r}")
    if not cluster_selection_epsilon >= 0:
        raise ValueError(f"cluster_selection_epsilon must be at least 0, got {cluster_selection_epsilon!r}")


def hdbscan_mst(points: np.ndarray, min_samples: int, threads: Optional[int] = None):
    """The minimum spanning tree of the mutual reachability of ``points`` (n, d), as
    ``(src, dst, weight)`` of its n - 1 edges in the order Prim's algorithm adds them from point
    0, as sklearn's ``mst_from_data_matrix`` (the lowest index among equal distances joins).
    The O(n^2 d) core distances and tree run on ``threads`` threads (torch's intra-op count by
    default)."""
    points = np.ascontiguousarray(points, dtype="float64")
    if points.ndim != 2:
        raise ValueError(f"HDBSCAN takes points of shape (n, d), got {points.shape}")
    n, d = points.shape
    if n < 2 or not 1 <= min_samples <= n:
        raise ValueError(f"HDBSCAN needs at least 2 points and no fewer than min_samples ({min_samples}); got {n}")
    if not np.isfinite(points).all():
        raise ValueError("HDBSCAN takes finite points")
    if threads is None:
        import torch

        threads = torch.get_num_threads()
    src, dst = np.empty(n - 1, dtype="int64"), np.empty(n - 1, dtype="int64")
    weight = np.empty(n - 1, dtype="float64")
    load_hdbscan_library().tem_hdbscan_mst(
        _ptr(points, ctypes.c_double), n, d, int(min_samples), max(1, int(threads)), _ptr(src, ctypes.c_int64),
        _ptr(dst, ctypes.c_int64), _ptr(weight, ctypes.c_double))
    return src, dst, weight


def hdbscan_labels(src, dst, weight, min_cluster_size: int, cluster_selection_epsilon: float = 0.0) -> np.ndarray:
    """HDBSCAN labels (-1 for noise) from the edges of the minimum spanning tree, ordered by
    weight: sklearn's single-linkage tree, condensed tree, excess-of-mass selection and
    labelling (``_tree.pyx:tree_to_labels``)."""
    src, dst = (np.ascontiguousarray(a, dtype="int64") for a in (src, dst))
    weight = np.ascontiguousarray(weight, dtype="float64")
    n = len(weight) + 1
    if src.shape != (n - 1,) or dst.shape != (n - 1,) or n < 2:
        raise ValueError(f"a tree's edges: {src.shape} sources, {dst.shape} destinations, {weight.shape} weights")
    if not 0 <= min(src.min(), dst.min()) <= max(src.max(), dst.max()) < n:
        raise ValueError(f"edges of a tree of {n} points end outside [0, {n})")
    _check_clustering(min_cluster_size, cluster_selection_epsilon)
    labels = np.empty(n, dtype="int64")
    load_hdbscan_library().tem_hdbscan_labels(
        _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64), _ptr(weight, ctypes.c_double), n,
        int(min_cluster_size), float(cluster_selection_epsilon), _ptr(labels, ctypes.c_int64))
    return labels


def hdbscan(points: np.ndarray, min_cluster_size: int, cluster_selection_epsilon: float = 0.0,
            threads: Optional[int] = None) -> np.ndarray:
    """HDBSCAN labels (-1 for noise) of ``points`` (n, d), equal to
    ``sklearn.cluster.HDBSCAN(min_cluster_size=..., cluster_selection_epsilon=...).fit_predict(points)``
    with sklearn's other defaults (euclidean, ``min_samples = min_cluster_size``, ``alpha`` 1,
    excess of mass, no single cluster), id for id: ``hdbscan_mst``, the edges ordered by
    ``np.argsort``'s default as sklearn orders them (its order of equal weights decides ties,
    so both make the same numpy call), then ``hdbscan_labels``. The points are taken as float64.
    """
    _check_clustering(min_cluster_size, cluster_selection_epsilon)
    src, dst, weight = hdbscan_mst(points, min_cluster_size, threads)
    order = np.argsort(weight)
    return hdbscan_labels(src[order], dst[order], weight[order], min_cluster_size, cluster_selection_epsilon)
