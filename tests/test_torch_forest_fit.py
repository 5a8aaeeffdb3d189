"""The port's forest fit (``shallow2deep/forest.py:fit_forest``, grown by ``ops/native/forest.cpp``)
against scikit-learn's ``RandomForestClassifier``, which the port no longer imports.

The forests must equal sklearn's node for node (``node_differences``): the same trees and node order,
``feature``, ``threshold`` bitwise, the children, the class fractions, the impurities and the sample
counts. Held against the committed fixtures of ``scripts/make_forest_fixtures.py`` (which
``chip_smoke.py`` phase 16a checks on the card), against live sklearn fits on seeded data with ties,
constant columns, repeated rows and every argument of ``RandomForestClassifier``, on 1 and 4 threads:
``class_weight`` in each form with and without the bootstrap (float sample weights, whose sums depend
on sklearn's sort and criterion order), ``max_leaf_nodes`` (best first), ``ccp_alpha`` (pruning),
``oob_score`` (its arrays bitwise), ``warm_start`` and ``monotonic_cst``; the missing-value direction of
every node too. The global ``np.random`` is left as sklearn leaves it; invalid arguments raise sklearn's
messages; ``forest_to_sklearn`` gives a sklearn forest that predicts and pickles as the fitted one, with
sklearn's own fitted state; the committed Shallow2Deep forests refit from their recipe. Inputs of at
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
from sklearn.tree._tree import NODE_DTYPE

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


# (labels, RandomForestClassifier kwargs) of the arguments beyond the trees' sizes, each against sklearn on data of
# its own seed: every class_weight form with and without the bootstrap (a fractional max_samples among them, which
# the class weights' sum scales), best-first trees, pruning (one value down to a stump), the out-of-bag score,
# warm_start, monotonic constraints, entropy with class weights
WEIGHTED = {0: 2.5, 1: 0.7}
NEW_CASES = {
    **{f"class_weight_{name}_{'bootstrap' if bootstrap else 'no_bootstrap'}": (
        labels, dict(n_estimators=4, class_weight=weight, bootstrap=bootstrap))
       for name, labels, weight in (("balanced", "three", "balanced"), ("subsample", "binary", "balanced_subsample"),
                                    ("dict", "binary", WEIGHTED), ("dict_three", "three", {0: 1.3, 2: 0.4, 5: 3.1}))
       for bootstrap in (True, False)},
    "class_weight_balanced_max_samples": ("binary", dict(n_estimators=4, class_weight="balanced", max_samples=0.4)),
    "class_weight_subsample_max_samples": ("three", dict(n_estimators=4, class_weight="balanced_subsample",
                                                         max_samples=0.6, min_weight_fraction_leaf=0.01)),
    "class_weight_min_weight_fraction": ("binary", dict(n_estimators=4, class_weight=WEIGHTED, bootstrap=False,
                                                        min_weight_fraction_leaf=0.03)),
    "max_leaf_nodes_2": ("binary", dict(n_estimators=4, max_leaf_nodes=2)),
    "max_leaf_nodes_7": ("three", dict(n_estimators=4, max_leaf_nodes=7)),
    "max_leaf_nodes_50": ("binary", dict(n_estimators=4, max_leaf_nodes=50, class_weight="balanced")),
    "ccp_alpha": ("three", dict(n_estimators=4, ccp_alpha=0.003)),
    "ccp_alpha_stump": ("binary", dict(n_estimators=4, ccp_alpha=0.5)),
    "ccp_alpha_best_first": ("binary", dict(n_estimators=4, ccp_alpha=0.002, max_leaf_nodes=40)),
    "oob_score": ("three", dict(n_estimators=6, oob_score=True)),
    "oob_score_class_weight": ("binary", dict(n_estimators=6, oob_score=True, class_weight="balanced_subsample")),
    "warm_start": ("binary", dict(n_estimators=4, warm_start=True)),
    "monotonic_cst": ("binary", dict(n_estimators=4, monotonic_cst=[1, 0, 0, -1, 0, 1, 0, 0])),
    "monotonic_cst_best_first": ("binary", dict(n_estimators=4, monotonic_cst=[-1, 1, 0, 0, 1, 0, 0, 0],
                                                max_leaf_nodes=30, class_weight="balanced")),
    "entropy_class_weight": ("three", dict(n_estimators=4, criterion="entropy", class_weight="balanced")),
    "entropy_subsample_no_bootstrap": ("binary", dict(n_estimators=4, criterion="entropy",
                                                      class_weight="balanced_subsample", bootstrap=False)),
}


def _sklearn(x, y, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return RandomForestClassifier(**kwargs).fit(x, y)


def _port(x, y, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fit_forest(x, y, **kwargs)


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.int64), b.view(np.int64))


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
    """The arguments that fit_forest once left to sklearn: each now gives sklearn's forest node for node or, where
    sklearn raises (two constraints for eight features), sklearn's error."""
    x, y = fixtures.fixture_data("binary", 5, n=50)
    kwargs = {name: value, "n_estimators": 3, "random_state": 5}
    try:
        expected = forest_from_sklearn(_sklearn(x, y, **kwargs))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fit_forest(x, y, **kwargs)
        assert str(got.value) == str(e)
        return
    assert node_differences(_port(x, y, **kwargs), expected) == []


@pytest.mark.parametrize("case", sorted(NEW_CASES))
def test_every_argument_matches_sklearn(case):
    labels, kwargs = NEW_CASES[case]
    seed = sorted(NEW_CASES).index(case)
    x, y = fixtures.fixture_data(labels, 300 + seed, n=800)
    if seed % 2:  # coarse values: many ties, whose order sklearn's introsort decides
        x = np.round(x * 4) / 4
    kwargs = dict(kwargs, random_state=seed)
    fitted = _sklearn(x, y, **kwargs)
    got = _port(x, y, n_jobs=2, **kwargs)
    assert node_differences(got, forest_from_sklearn(fitted)) == []
    assert got.missing_go_to_left is not None and got.params["class_weight"] == kwargs.get("class_weight")
    if kwargs.get("oob_score"):
        assert _bitwise(got.oob_decision_function_, fitted.oob_decision_function_)
        assert got.oob_score_ == fitted.oob_score_
    else:
        assert got.oob_decision_function_ is None and not hasattr(fitted, "oob_decision_function_")


def test_warm_start_grows_the_default_forest():
    """Each fit starts from no trees, as each RandomForestClassifier the JAX package builds: warm_start=True gives the
    forest of warm_start=False and records the flag; a class-weight preset warns as sklearn warns."""
    x, y = fixtures.fixture_data("three", 31)
    warm = fit_forest(x, y, n_estimators=4, random_state=31, warm_start=True)
    cold = fit_forest(x, y, n_estimators=4, random_state=31)
    assert node_differences(warm, cold) == [] and warm.params["warm_start"] and not cold.params["warm_start"]
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        RandomForestClassifier(n_estimators=2, class_weight="balanced", warm_start=True, random_state=1).fit(x, y)
    with warnings.catch_warnings(record=True) as ours:
        warnings.simplefilter("always")
        fit_forest(x, y, n_estimators=2, class_weight="balanced", warm_start=True, random_state=1)
    assert [str(w.message) for w in ours] == [str(w.message) for w in theirs] and len(ours) == 1


def test_oob_score_warnings_errors_and_scoring():
    """sklearn's warnings (a sample no tree left out, a small fractional bootstrap), its error without the bootstrap,
    and a scoring function of the labels and the out-of-bag classes."""
    x, y = fixtures.fixture_data("binary", 32, n=200)
    for kwargs in (dict(n_estimators=2, oob_score=True, random_state=3), dict(n_estimators=3, max_samples=0.04,
                                                                               oob_score=True, random_state=4)):
        with warnings.catch_warnings(record=True) as theirs:
            warnings.simplefilter("always")
            fitted = RandomForestClassifier(**kwargs).fit(x, y)
        with warnings.catch_warnings(record=True) as ours:
            warnings.simplefilter("always")
            got = fit_forest(x, y, **kwargs)
        assert sorted(str(w.message) for w in ours) == sorted(str(w.message) for w in theirs) and ours
        assert _bitwise(got.oob_decision_function_, fitted.oob_decision_function_)
        assert got.oob_score_ == fitted.oob_score_
    # a scoring function of the labels and the out-of-bag classes, as sklearn calls it
    from sklearn.metrics import balanced_accuracy_score
    fitted = _sklearn(x, y, n_estimators=8, oob_score=balanced_accuracy_score, random_state=5)
    got = _port(x, y, n_estimators=8, oob_score=balanced_accuracy_score, random_state=5)
    assert got.oob_score_ == fitted.oob_score_ and _bitwise(got.oob_decision_function_,
                                                            fitted.oob_decision_function_)
    with pytest.raises(ValueError, match="Out of bag estimation only available if bootstrap=True"):
        fit_forest(x, y, oob_score=True, bootstrap=False)


@pytest.mark.parametrize("kwargs, labels", [
    (dict(max_leaf_nodes=1), "binary"), (dict(max_leaf_nodes=2.5), "binary"), (dict(ccp_alpha=-1), "binary"),
    (dict(class_weight="foo"), "binary"), (dict(class_weight={0: 1, 7: 2}), "binary"),
    (dict(class_weight=[{0: 1}]), "binary"), (dict(oob_score=1), "binary"), (dict(warm_start=1), "binary"),
    (dict(monotonic_cst=[1, 0]), "binary"), (dict(monotonic_cst=[1, 0, 0, 0, 0, 0, 0, 2]), "binary"),
    (dict(monotonic_cst=[1, 0, 0, 0, 0, 0, 0, 0]), "three"), (dict(monotonic_cst=5), "binary")])
def test_invalid_new_arguments_raise_sklearns_messages(kwargs, labels):
    x, y = fixtures.fixture_data(labels, 33, n=60)
    with pytest.raises(ValueError) as theirs:
        RandomForestClassifier(n_estimators=2, **kwargs).fit(x, y)
    with pytest.raises(ValueError) as ours:
        fit_forest(x, y, n_estimators=2, **kwargs)
    assert str(ours.value) == str(theirs.value)


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
    # sklearn's own fitted state, but for the private attributes of its fit
    private = {"_n_samples", "_sample_weight", "_n_samples_bootstrap"}
    assert list(unpickled.__dict__) == [k for k in fitted.__dict__ if k not in private] + [
        "feature_ndim", "feature_config", "train_features", "train_labels"]
    for mine, theirs in zip(unpickled.estimators_, fitted.estimators_):
        assert list(mine.__dict__) == list(theirs.__dict__)
        assert type(mine.n_classes_) is type(theirs.n_classes_) and mine.n_classes_ == theirs.n_classes_
        assert mine.tree_.__getstate__()["nodes"].dtype == NODE_DTYPE
        assert mine.tree_.__getstate__()["nodes"].tobytes() == theirs.tree_.__getstate__()["nodes"].tobytes()
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
