"""Small HDBSCAN fixtures clustered by scikit-learn, as evidence that the port's native HDBSCAN
(``torch_em_tpu_torch/ops/native/hdbscan.cpp``, ``ops.native.hdbscan``) gives sklearn's labels id
for id where sklearn is not installed.

    python scripts/make_hdbscan_fixtures.py

writes ``scripts/records/hdbscan/<case>.npz`` for each case of ``CASES``: the points (float32, as
a model's embeddings are), ``min_cluster_size``, ``cluster_selection_epsilon`` and the labels of
``sklearn.cluster.HDBSCAN(min_cluster_size=..., cluster_selection_epsilon=...).fit_predict``, with
the sklearn and numpy versions; sklearn's minimum spanning tree in the order Prim's algorithm
added its edges (``mst_src``, ``mst_dst``, ``mst_weight``) and the order in which sklearn's
``np.argsort`` sorted them (``order``); and ``tie_order_free``: whether the labels stay the same
when the tree's equal weights are taken in index order and in the reverse order. numpy's default
argsort does not keep the order of equal weights, and its order is numpy's and the CPU's: where a
case is not tie-order free, another numpy can give other labels, in sklearn as in the port, and
the recorded order separates the two. ``tests/test_torch_hdbscan.py`` holds the port
against the fixtures and against sklearn here, ``chip_smoke.py`` (phase 24c) on the card.

The cases: blobs of 2 and 8 dimensions, a case where a quarter of the points repeat another
quarter, and cluster selection epsilons 0 and above 0.

    python scripts/make_hdbscan_fixtures.py --time

writes nothing and prints the seconds of sklearn's HDBSCAN and of the port's on 1, 2 and 4
threads for 16384 points of 8 dimensions (a 128x128 crop of 8-dimensional embeddings), on this
machine's CPU, each the best of three, with the labels' agreement.
"""

import argparse
import time
import warnings
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parent / "records" / "hdbscan"
# name, points, dimensions, blob centres, duplicates, min_cluster_size, cluster_selection_epsilon
CASES = (
    ("blobs2d_eps0", 1024, 2, 5, False, 10, 0.0),
    ("blobs2d_eps1", 1024, 2, 5, False, 10, 1.0),
    ("blobs8d_eps0", 2048, 8, 8, False, 15, 0.0),
    ("blobs8d_eps2", 2048, 8, 8, False, 15, 2.0),
    ("duplicates8d_eps0", 2048, 8, 6, True, 5, 0.0),
    ("duplicates8d_eps05", 2048, 8, 6, True, 5, 0.5),
)


def fixture_points(case, seed: int) -> np.ndarray:
    """The points of ``case``: isotropic blobs around normal centres spread 4x wider, float32."""
    _, n, d, centres, duplicates, _, _ = case
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=4.0, size=(centres, d))
    points = (means[rng.integers(0, centres, n)] + rng.normal(size=(n, d))).astype(np.float32)
    if duplicates:
        quarter = n // 4
        points[:quarter] = points[quarter: 2 * quarter]
    return points


def _labels_in_tie_orders(points, min_cluster_size, eps):
    """sklearn's labels, and its labels with the MST's equal weights in index order and reversed."""
    import sklearn.cluster._hdbscan.hdbscan as sk_hdbscan
    from sklearn.cluster import HDBSCAN
    from sklearn.cluster._hdbscan._linkage import make_single_linkage
    from sklearn.cluster._hdbscan._tree import tree_to_labels

    captured = {}
    process_mst = sk_hdbscan._process_mst

    def capture(mst):
        captured["mst"] = mst.copy()
        return process_mst(mst)

    sk_hdbscan._process_mst = capture
    try:
        labels = HDBSCAN(min_cluster_size=min_cluster_size, cluster_selection_epsilon=eps).fit_predict(points)
    finally:
        sk_hdbscan._process_mst = process_mst
    mst = captured["mst"]
    captured["order"] = np.argsort(mst["distance"])  # sklearn's own call, hdbscan.py:_process_mst
    index = np.arange(len(mst))
    others = []
    for order in (np.lexsort((index, mst["distance"])), np.lexsort((-index, mst["distance"]))):
        tree = make_single_linkage(np.ascontiguousarray(mst[order]))
        others.append(tree_to_labels(tree, min_cluster_size, "eom", False, eps, None)[0])
    return labels, others, captured


def main():
    import numpy
    import sklearn

    warnings.filterwarnings("ignore", category=FutureWarning)
    OUT.mkdir(parents=True, exist_ok=True)
    for seed, case in enumerate(CASES):
        name, _, _, _, _, min_cluster_size, eps = case
        points = fixture_points(case, seed)
        labels, others, captured = _labels_in_tie_orders(points, min_cluster_size, eps)
        tie_order_free = all(np.array_equal(labels, other) for other in others)
        mst = captured["mst"]
        np.savez_compressed(OUT / f"{name}.npz", points=points, labels=labels.astype(np.int32),
                            min_cluster_size=min_cluster_size, cluster_selection_epsilon=eps,
                            mst_src=mst["current_node"].astype(np.int32), mst_dst=mst["next_node"].astype(np.int32),
                            mst_weight=mst["distance"], order=captured["order"].astype(np.int32),
                            tie_order_free=tie_order_free, sklearn_version=sklearn.__version__,
                            numpy_version=numpy.__version__)
        print(f"{name}: {points.shape}, {labels.max() + 1} clusters, {(labels < 0).sum()} noise points, "
              f"tie-order free {tie_order_free}")


def time_cpu(n=16384, d=8, min_cluster_size=50, eps=0.2):
    """Best-of-three seconds of sklearn's HDBSCAN and the port's on this CPU."""
    import sys

    from sklearn.cluster import HDBSCAN

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from torch_em_tpu_torch.ops import native

    warnings.filterwarnings("ignore", category=FutureWarning)
    points = fixture_points(("timing", n, d, 8, False, None, None), 0)
    native.hdbscan(points[:64], 2)  # the build

    def best(fn):
        times = []
        for _ in range(3):
            t = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t)
        return min(times), out

    sk_s, expected = best(lambda: HDBSCAN(min_cluster_size=min_cluster_size,
                                          cluster_selection_epsilon=eps).fit_predict(points))
    print(f"{n} points of {d} dimensions, min_cluster_size {min_cluster_size}, eps {eps}: sklearn {sk_s:.3f} s")
    for threads in (1, 2, 4):
        s, got = best(lambda: native.hdbscan(points, min_cluster_size, eps, threads=threads))
        print(f"port on {threads} thread(s): {s:.3f} s, labels equal {bool((got == expected).all())}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--time", action="store_true", help="time sklearn and the port on this CPU; write nothing")
    if parser.parse_args().time:
        time_cpu()
    else:
        main()
