"""The port's forest fit (``shallow2deep/forest.py:fit_forest``, grown by ``ops/native/forest.cpp``)
against scikit-learn's ``RandomForestClassifier``, which the port no longer imports.

The forests must equal sklearn's node for node (``node_differences``): the same trees and node order,
``feature``, ``threshold`` bitwise, the children, the class fractions, the impurities and the sample
counts. Held against the committed fixtures of ``scripts/make_forest_fixtures.py`` (which
``chip_smoke.py`` phase 16a checks on the card), against live sklearn fits on seeded data with ties,
constant columns, repeated rows and every supported argument, on 1 and 4 threads; the global
``np.random`` is left as sklearn leaves it; ``forest_to_sklearn`` gives a sklearn forest that predicts
and pickles as the fitted one; the committed Shallow2Deep forests refit from their recipe. Inputs of at
most a few thousand samples keep the file to seconds.
"""

import pickle
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np
import pytest
from sklearn.ensemble import RandomForestClassifier

from torch_em_tpu_torch.shallow2deep import (
    fit_forest, forest_from_sklearn, forest_to_sklearn, load_forest, node_differences, save_forest,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import make_forest_fixtures as fixtures  # noqa: E402

FIXTURES = sorted((REPO / "scripts" / "records" / "forest").glob("*.npz"))
# (labels, RandomForestClassifier kwargs) of the live comparisons, each on data of its own seed
RANDOM_CASES = (
    ("binary", dict(n_estimators=6, random_state=10)),
    ("three", dict(n_estimators=6, random_state=11, criterion="log_loss", max_features=3)),
    ("binary", dict(n_estimators=4, random_state=12, max_features=None, min_samples_split=0.05)),
    ("three", dict(n_estimators=4, random_state=13, min_samples_leaf=0.02, max_samples=300)),
    ("binary", dict(n_estimators=4, random_state=14, min_weight_fraction_leaf=0.02, criterion="entropy")),
    ("three", dict(n_estimators=4, random_state=15, bootstrap=False, max_depth=4, max_features=0.3)),
    ("binary", dict(n_estimators=4, random_state="RandomState(16)", min_impurity_decrease=0.001)),
    ("three", dict(n_estimators=3, random_state=17, min_samples_split=9, min_samples_leaf=2)),
)


def _sklearn(x, y, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return RandomForestClassifier(**kwargs).fit(x, y)


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_fixture_node_for_node(path):
    differences, same_draw, _ = fixtures.refit_fixture(path)
    assert differences == []
    assert same_draw in (None, True)


@pytest.mark.parametrize("case", range(len(RANDOM_CASES)))
def test_random_cases_match_sklearn(case):
    labels, kwargs = RANDOM_CASES[case]
    x, y = fixtures.fixture_data(labels, 100 + case, n=1500)
    # float64, which both sides cast to float32
    x = x.astype(np.float64) + np.random.RandomState(case).normal(scale=1e-3, size=x.shape)
    if kwargs["random_state"] == "RandomState(16)":  # a RandomState instance, one for each side
        expected = forest_from_sklearn(_sklearn(x, y, **dict(kwargs, random_state=np.random.RandomState(16))))
        got = fit_forest(x, y, **dict(kwargs, random_state=np.random.RandomState(16)))
    else:
        expected = forest_from_sklearn(_sklearn(x, y, **kwargs))
        got = fit_forest(x, y, **kwargs)
    assert node_differences(got, expected) == []
    assert np.array_equal(got.threshold.view(np.int64), expected.threshold.view(np.int64))


def test_threads_do_not_change_the_trees():
    x, y = fixtures.fixture_data("three", 3, n=2000)
    one = fit_forest(x, y, n_estimators=12, random_state=3, n_jobs=1)
    four = fit_forest(x, y, n_estimators=12, random_state=3, n_jobs=4)
    assert node_differences(one, four) == []
    assert node_differences(four, forest_from_sklearn(_sklearn(x, y, n_estimators=12, random_state=3,
                                                               n_jobs=4))) == []


def test_global_random_state_left_as_sklearn_leaves_it():
    x, y = fixtures.fixture_data("binary", 4)
    np.random.seed(21)
    expected = forest_from_sklearn(_sklearn(x, y, n_estimators=5))
    state = np.random.get_state()
    np.random.seed(21)
    got = fit_forest(x, y, n_estimators=5)
    after = np.random.get_state()
    assert node_differences(got, expected) == []
    assert np.array_equal(after[1], state[1]) and after[2:] == state[2:]


@pytest.mark.parametrize("name, value", [("max_leaf_nodes", 8), ("class_weight", "balanced"), ("oob_score", True),
                                         ("warm_start", True), ("ccp_alpha", 0.01), ("monotonic_cst", [1, 0])])
def test_unimplemented_arguments_raise(name, value):
    x, y = fixtures.fixture_data("binary", 5, n=50)
    with pytest.raises(NotImplementedError, match=name):
        fit_forest(x, y, **{name: value})


def test_invalid_inputs_raise():
    x, y = fixtures.fixture_data("binary", 6, n=50)
    bad = x.copy()
    bad[3, 1] = np.nan
    with pytest.raises(ValueError, match="finite"):
        fit_forest(bad, y)
    with pytest.raises(TypeError, match="no_such_argument"):
        fit_forest(x, y, no_such_argument=1)
    with pytest.raises(ValueError, match="max_sample"):
        fit_forest(x, y, bootstrap=False, max_samples=0.5)
    with pytest.raises(ValueError, match="continuous"):
        fit_forest(x, y + 0.5)


def test_forest_to_sklearn_predicts_and_pickles_as_fitted(tmp_path):
    x, y = fixtures.fixture_data("three", 7)
    fitted = _sklearn(x, y, n_estimators=6, random_state=7, max_depth=8)
    forest = fit_forest(x, y, n_estimators=6, random_state=7, max_depth=8)
    forest.feature_ndim, forest.feature_config = 2, [("gaussianSmoothing", 0.7)]
    forest.train_features, forest.train_labels = x, y
    rebuilt = forest_to_sklearn(forest)
    with open(tmp_path / "rf.pkl", "wb") as f:
        pickle.dump(rebuilt, f)
    loaded = load_forest(str(tmp_path / "rf.pkl"))
    with open(tmp_path / "rf.pkl", "rb") as f:
        unpickled = pickle.load(f)
    test = np.random.RandomState(8).normal(size=(500, x.shape[1]))
    assert np.array_equal(unpickled.predict_proba(test), fitted.predict_proba(test))
    assert np.array_equal(unpickled.predict(test), fitted.predict(test))
    assert [e.tree_.max_depth for e in unpickled.estimators_] == [e.tree_.max_depth for e in fitted.estimators_]
    assert [e.random_state for e in unpickled.estimators_] == [e.random_state for e in fitted.estimators_]
    for mine, theirs in zip(unpickled.estimators_, fitted.estimators_):
        split = theirs.tree_.children_left >= 0
        assert np.array_equal(mine.tree_.missing_go_to_left[split], theirs.tree_.missing_go_to_left[split])
    assert unpickled.get_params() == fitted.get_params()
    assert unpickled.feature_ndim == 2 and unpickled.feature_config == [("gaussianSmoothing", 0.7)]
    assert np.array_equal(unpickled.train_labels, y)
    assert node_differences(loaded, forest) == [] and node_differences(loaded, forest_from_sklearn(fitted)) == []


def test_npz_keeps_the_node_statistics(tmp_path):
    x, y = fixtures.fixture_data("binary", 9, n=300)
    forest = fit_forest(x, y, n_estimators=3, random_state=9)
    save_forest(forest, str(tmp_path / "rf.npz"))
    loaded = load_forest(str(tmp_path / "rf.npz"))
    assert node_differences(loaded, forest) == []
    assert all(getattr(loaded, k) is not None for k in ("impurity", "n_node_samples", "weighted_n_node_samples"))
    # a forest written without them (as the committed Shallow2Deep forests) loads and compares on the rest
    committed = load_forest(str(REPO / "scripts" / "s2d_forests" / "rf_0000.npz"))
    assert committed.impurity is None and node_differences(committed, committed) == []


def test_committed_shallow2deep_forests_refit():
    """The recipe of scripts/torch_s2d_forests.py, fitted by the port, gives the committed forests,
    which sklearn fitted, node for node, from features of the recorded sha256."""
    import json

    import torch_s2d_forests

    with tempfile.TemporaryDirectory() as tmp:
        paths, digest, _ = torch_s2d_forests.fit_forests(tmp)
        differences = torch_s2d_forests.check_against_committed(paths)
    with open(torch_s2d_forests.RECIPE_RECORD) as f:
        assert digest == json.load(f)["features_sha256"]
    assert differences == {f"rf_{i:04d}.npz": [] for i in range(4)}
