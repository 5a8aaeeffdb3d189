"""Multicut segmentation: watershed superpixels + RAG + greedy agglomeration.

Host-side rebuild of the elf.segmentation multicut pipeline the reference
metrics use (torch_em/metric/instance_segmentation_metric.py:123-155):
``distance_transform_watershed``, ``compute_rag``,
``compute_boundary_mean_and_length``, ``compute_edge_costs`` and a
greedy-additive-edge-contraction (GAEC) multicut solver. The port's copy of
the JAX package's ``ops/multicut.py``.
"""

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import ndimage

from . import host as ops
from . import native

__all__ = [
    "distance_transform_watershed", "stacked_watershed", "compute_rag",
    "compute_boundary_mean_and_length", "compute_edge_costs", "multicut_gaec",
    "project_node_labels_to_pixels", "multicut_segmentation",
]


def distance_transform_watershed(
    boundaries: np.ndarray, threshold: float = 0.25, sigma_seeds: float = 2.0,
    sigma_weights: float = 2.0, min_size: int = 0,
) -> Tuple[np.ndarray, int]:
    """Watershed superpixels seeded at maxima of the boundary-distance transform
    (functional spec: elf.segmentation.distance_transform_watershed)."""
    thresholded = boundaries < threshold
    dt = ndimage.distance_transform_edt(thresholded).astype("float32")
    if sigma_seeds > 0:
        dt = ndimage.gaussian_filter(dt, sigma_seeds)
    max_filt = ndimage.maximum_filter(dt, size=3)
    seeds_mask = (dt == max_filt) & (dt > 0)
    seeds = ops.connected_components(seeds_mask)
    hmap = ndimage.gaussian_filter(boundaries.astype("float32"), sigma_weights) if sigma_weights > 0 \
        else boundaries.astype("float32")
    ws = native.watershed(hmap, seeds.astype("uint32"))
    if min_size > 0:
        from ..utils.segmentation import size_filter

        ws = size_filter(ws, min_size, hmap=hmap)
    max_id = int(ws.max())
    return ws, max_id


def stacked_watershed(boundaries: np.ndarray, threshold: float = 0.25, sigma_seed: float = 2.0,
                      sigma_weights: float = 2.0, **kwargs) -> Tuple[np.ndarray, int]:
    """Per-z-slice 2D watershed for anisotropic 3D volumes
    (functional spec: elf.segmentation.stacked_watershed)."""
    ws = np.zeros(boundaries.shape, dtype="uint32")
    offset = 0
    for z in range(boundaries.shape[0]):
        wsz, max_id = distance_transform_watershed(
            boundaries[z], threshold=threshold, sigma_seeds=sigma_seed, sigma_weights=sigma_weights
        )
        wsz = wsz.astype("uint32")
        wsz[wsz != 0] += offset
        ws[z] = wsz
        offset += max_id
    return ws, int(offset)


def compute_rag(seg: np.ndarray) -> np.ndarray:
    """Region adjacency graph edges (u, v) with u < v (connectivity 1)."""
    seg = np.asarray(seg).astype("int64")
    pairs = []
    for axis in range(seg.ndim):
        sl_a = tuple(slice(None, -1) if d == axis else slice(None) for d in range(seg.ndim))
        sl_b = tuple(slice(1, None) if d == axis else slice(None) for d in range(seg.ndim))
        a, b = seg[sl_a].ravel(), seg[sl_b].ravel()
        diff = a != b
        pairs.append(np.stack([a[diff], b[diff]], axis=1))
    if not pairs:
        return np.zeros((0, 2), dtype="int64")
    edges = np.concatenate(pairs, axis=0)
    edges = np.sort(edges, axis=1)
    return np.unique(edges, axis=0)


def compute_boundary_mean_and_length(seg: np.ndarray, boundaries: np.ndarray,
                                     edges: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Mean boundary probability and face length per RAG edge."""
    seg = np.asarray(seg).astype("int64")
    if edges is None:
        edges = compute_rag(seg)
    edge_index = {tuple(e): i for i, e in enumerate(map(tuple, edges))}
    sums = np.zeros(len(edges), dtype="float64")
    counts = np.zeros(len(edges), dtype="float64")
    for axis in range(seg.ndim):
        sl_a = tuple(slice(None, -1) if d == axis else slice(None) for d in range(seg.ndim))
        sl_b = tuple(slice(1, None) if d == axis else slice(None) for d in range(seg.ndim))
        a, b = seg[sl_a].ravel(), seg[sl_b].ravel()
        vals = ((boundaries[sl_a] + boundaries[sl_b]) / 2).ravel()
        diff = a != b
        ea = np.minimum(a[diff], b[diff])
        eb = np.maximum(a[diff], b[diff])
        v = vals[diff]
        for u, w, val in zip(ea, eb, v):
            i = edge_index[(u, w)]
            sums[i] += val
            counts[i] += 1
    means = sums / np.maximum(counts, 1)
    return means.astype("float32"), counts.astype("float32")


def compute_edge_costs(probs: np.ndarray, beta: float = 0.5, weighting: Optional[np.ndarray] = None) -> np.ndarray:
    """Boundary probabilities -> multicut costs (logit transform, elf parity).

    Positive cost = attraction (merge), negative = repulsion.
    """
    p = np.clip(np.asarray(probs, dtype="float64"), 1e-6, 1 - 1e-6)
    costs = np.log((1.0 - p) / p) + np.log((1.0 - beta) / beta)
    if weighting is not None:
        costs *= weighting
    return costs.astype("float32")


def multicut_gaec(n_nodes: int, edges: np.ndarray, costs: np.ndarray) -> np.ndarray:
    """Greedy additive edge contraction multicut solver.

    Repeatedly contracts the highest-positive-cost edge, accumulating parallel
    edge costs, until no positive edge remains. Returns node labels.
    """
    # adjacency: node -> {neighbor: cost}
    adj: List[Dict[int, float]] = [dict() for _ in range(n_nodes)]
    for (u, v), c in zip(edges, costs):
        u, v = int(u), int(v)
        adj[u][v] = adj[u].get(v, 0.0) + float(c)
        adj[v][u] = adj[v].get(u, 0.0) + float(c)

    parent = np.arange(n_nodes)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    heap = []
    for u in range(n_nodes):
        for v, c in adj[u].items():
            if u < v and c > 0:
                heapq.heappush(heap, (-c, u, v))

    while heap:
        neg_c, u, v = heapq.heappop(heap)
        ru, rv = find(u), find(v)
        if ru == rv:
            continue
        # lazy validation: current cost between the clusters
        cur = adj[ru].get(rv)
        if cur is None or abs(cur + neg_c) > 1e-9:
            if cur is not None and cur > 0:
                heapq.heappush(heap, (-cur, ru, rv))
            continue
        if cur <= 0:
            continue
        # contract rv into ru (keep the larger adjacency)
        if len(adj[rv]) > len(adj[ru]):
            ru, rv = rv, ru
        parent[rv] = ru
        adj[ru].pop(rv, None)
        adj[rv].pop(ru, None)
        for w, c in adj[rv].items():
            adj[w].pop(rv, None)
            rw = find(w)
            if rw == ru:
                continue
            new_c = adj[ru].get(rw, 0.0) + c
            adj[ru][rw] = new_c
            adj[rw][ru] = new_c
            if new_c > 0:
                heapq.heappush(heap, (-new_c, ru, rw))
        adj[rv] = {}

    labels = np.zeros(n_nodes, dtype="int64")
    roots = {}
    next_label = 0
    for i in range(n_nodes):
        r = find(i)
        if r not in roots:
            roots[r] = next_label
            next_label += 1
        labels[i] = roots[r]
    return labels


def project_node_labels_to_pixels(seg: np.ndarray, node_labels: np.ndarray) -> np.ndarray:
    return node_labels[np.asarray(seg).astype("int64")]


def multicut_segmentation(
    boundaries: np.ndarray, threshold: float = 0.25, sigma_seeds: float = 2.0,
    anisotropic: bool = False, beta: float = 0.5,
) -> np.ndarray:
    """Full pipeline: superpixels -> RAG -> costs -> GAEC -> pixel labels."""
    if anisotropic and boundaries.ndim == 3:
        ws, max_id = stacked_watershed(boundaries, threshold=threshold, sigma_seed=sigma_seeds,
                                       sigma_weights=sigma_seeds)
    else:
        ws, max_id = distance_transform_watershed(boundaries, threshold=threshold,
                                                  sigma_seeds=sigma_seeds, sigma_weights=sigma_seeds)
    edges = compute_rag(ws)
    if len(edges) == 0:
        return ws.astype("uint32")
    feats, _ = compute_boundary_mean_and_length(ws, boundaries, edges)
    costs = compute_edge_costs(feats, beta=beta)
    node_labels = multicut_gaec(max_id + 1, edges, costs)
    return project_node_labels_to_pixels(ws, node_labels).astype("uint32")
