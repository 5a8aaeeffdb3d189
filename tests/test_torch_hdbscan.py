"""The port's native HDBSCAN (``ops/native/hdbscan.cpp``, ``ops.native.hdbscan``) against
scikit-learn's ``HDBSCAN``, which the port no longer imports.

The labels must equal sklearn's id for id, not up to a permutation (``metric.HDBScan`` with
``remove_largest`` drops the largest segment, ties broken by the first id): over 2-D and 8-D
blobs, several ``min_cluster_size`` and ``cluster_selection_epsilon`` values, points that repeat
and points on a grid (many equal distances), and the committed fixtures of
``scripts/make_hdbscan_fixtures.py``, which ``chip_smoke.py`` (phase 24c) checks on the card. The
minimum spanning tree is also held bitwise against sklearn's, edge for edge in Prim's order. All
inputs have at most 2048 points: both sides are O(n^2).
"""

import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
from sklearn.cluster import HDBSCAN

from torch_em_tpu_torch.ops import native

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import make_hdbscan_fixtures as fixtures  # noqa: E402

FIXTURES = sorted((REPO / "scripts" / "records" / "hdbscan").glob("*.npz"))


def _blobs(n, d, seed, duplicates=False, grid=False):
    points = fixtures.fixture_points(("case", n, d, 6, duplicates, None, None), seed)
    return np.round(points * 2) / 2 if grid else points


def _sklearn(points, min_cluster_size, eps):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return HDBSCAN(min_cluster_size=min_cluster_size, cluster_selection_epsilon=eps).fit_predict(points)


@pytest.mark.parametrize("eps", [0.0, 0.5])
@pytest.mark.parametrize("min_cluster_size", [2, 5, 15])
@pytest.mark.parametrize("d", [2, 8])
def test_labels_equal_sklearn_on_blobs(d, min_cluster_size, eps):
    points = _blobs(1200 if d == 2 else 1500, d, seed=10 * d + min_cluster_size)
    np.testing.assert_array_equal(native.hdbscan(points, min_cluster_size, eps),
                                  _sklearn(points, min_cluster_size, eps))


@pytest.mark.parametrize("kind", ["duplicates", "grid"])
@pytest.mark.parametrize("eps", [0.0, 1.0])
def test_labels_equal_sklearn_with_equal_distances(kind, eps):
    points = _blobs(1000, 2 if kind == "grid" else 8, seed=3, duplicates=kind == "duplicates", grid=kind == "grid")
    for min_cluster_size in (3, 8):
        np.testing.assert_array_equal(native.hdbscan(points, min_cluster_size, eps),
                                      _sklearn(points, min_cluster_size, eps))


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_fixtures(path):
    """The tree bitwise in Prim's order, the labels from sklearn's sorted tree (which do not depend
    on numpy's order of equal weights), and the labels of the whole call."""
    case = np.load(path)
    m, eps = int(case["min_cluster_size"]), float(case["cluster_selection_epsilon"])
    src, dst, weight = native.hdbscan_mst(case["points"], m)
    np.testing.assert_array_equal(src, case["mst_src"])
    np.testing.assert_array_equal(dst, case["mst_dst"])
    np.testing.assert_array_equal(weight, case["mst_weight"])
    order = case["order"]
    np.testing.assert_array_equal(native.hdbscan_labels(src[order], dst[order], weight[order], m, eps), case["labels"])
    np.testing.assert_array_equal(native.hdbscan(case["points"], m, eps), case["labels"])


def test_fixtures_cover_the_cases():
    assert [p.stem for p in FIXTURES] == sorted(case[0] for case in fixtures.CASES)
    dims = {np.load(p)["points"].shape[1] for p in FIXTURES}
    epsilons = {float(np.load(p)["cluster_selection_epsilon"]) > 0 for p in FIXTURES}
    assert dims == {2, 8} and epsilons == {False, True}


def test_tree_equals_sklearns():
    points = _blobs(900, 8, seed=5)
    for min_samples in (4, 12):
        _, _, captured = fixtures._labels_in_tie_orders(points, min_samples, 0.0)
        src, dst, weight = native.hdbscan_mst(points, min_samples)
        np.testing.assert_array_equal(src, captured["mst"]["current_node"])
        np.testing.assert_array_equal(dst, captured["mst"]["next_node"])
        np.testing.assert_array_equal(weight, captured["mst"]["distance"])


def test_threads_change_nothing():
    points = _blobs(1500, 8, seed=7, duplicates=True)
    expected = native.hdbscan(points, 5, 0.0, threads=1)
    for threads in (2, 3, 7):
        np.testing.assert_array_equal(native.hdbscan(points, 5, 0.0, threads=threads), expected)


@pytest.mark.parametrize("call", [
    lambda: native.hdbscan(np.zeros((4, 2)), 5),
    lambda: native.hdbscan(np.zeros((4, 2)), 1),
    lambda: native.hdbscan(np.array([[0.0, np.nan], [1.0, 1.0]]), 2),
    lambda: native.hdbscan(np.zeros(4), 2),
    lambda: native.hdbscan(np.zeros((4, 2)), 2, -0.5),
], ids=["too_few_points", "min_size_1", "nan", "one_axis", "negative_eps"])
def test_rejects_what_sklearn_rejects(call):
    with pytest.raises(ValueError):
        call()
