"""Small random forests fitted by scikit-learn, and sklearn's classification scores, as evidence that the
port's native forest fit (``torch_em_tpu_torch/shallow2deep/forest.py:fit_forest``, grown by
``ops/native/forest.cpp``) and its numpy scores (``classification/scores.py``) equal sklearn's where
sklearn is not installed.

    python scripts/make_forest_fixtures.py

writes, under ``scripts/records/forest/``:

- ``<case>.npz`` for each case of ``FOREST_CASES``: the node arrays of
  ``RandomForestClassifier(**kwargs).fit(X, y)`` as ``shallow2deep.forest.save_forest`` writes them
  (``feature``, ``threshold``, the children, ``value``, ``impurity``, ``n_node_samples``,
  ``weighted_n_node_samples``, ``node_offsets``, ``classes``), the case's ``kwargs`` (JSON), the sha256
  of its data, the global seed set before the fit (-1 for none) and the next ``np.random.randint(2**31)``
  after it, and the sklearn and numpy versions. The data are not stored: ``fixture_data`` makes them
  from ``np.random.RandomState(seed)``, whose stream numpy keeps frozen: continuous float32 columns,
  quantized columns that tie, a constant column, a quarter of the rows repeating another quarter, and
  labels in {0, 1} or {0, 2, 5};
- ``classification_scores.json``: the seeded label vectors of ``SCORE_LABELS`` and, for each case of
  ``SCORE_CASES``, sklearn's value;
- ``s2d_recipe.json``: the sha256 of the features and labels that the recipe of
  ``scripts/torch_s2d_forests.py`` fits its forests on, computed on this CPU.

``tests/test_torch_forest_fit.py`` and ``tests/test_torch_classification.py`` hold the port against
these and against sklearn here, ``chip_smoke.py`` (phases 16a, 16b and 21) on the card.

    python scripts/make_forest_fixtures.py --time

writes nothing and prints the seconds of sklearn's fit and of the port's on this CPU, for a forest of
Shallow2Deep's size (sklearn's default 100 trees on 32768 samples of 28 features), each the best of
three, with 1 and 4 threads.
"""

import argparse
import hashlib
import json
import os
import sys
import time
import warnings
import zipfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT = REPO / "scripts" / "records" / "forest"
N_SAMPLES = 600
# name, labels ("binary": {0, 1}; "three": {0, 2, 5}), data seed, RandomForestClassifier kwargs, global seed (or None)
FOREST_CASES = (
    ("default", "binary", 0, dict(n_estimators=10, random_state=0), None),
    ("entropy", "three", 1, dict(n_estimators=5, criterion="entropy", random_state=1), None),
    ("max_features_none", "binary", 2, dict(n_estimators=5, max_features=None, random_state=2), None),
    ("max_features_half", "three", 3, dict(n_estimators=5, max_features=0.5, random_state=3), None),
    ("max_features_log2", "binary", 4, dict(n_estimators=5, max_features="log2", random_state=4), None),
    ("no_bootstrap", "three", 5, dict(n_estimators=5, bootstrap=False, random_state=5), None),
    ("max_samples_half", "binary", 6, dict(n_estimators=5, max_samples=0.5, random_state=6), None),
    ("depth6_leaf3", "three", 7, dict(n_estimators=5, max_depth=6, min_samples_leaf=3, random_state=7), None),
    ("min_impurity_decrease", "binary", 8, dict(n_estimators=5, min_impurity_decrease=0.002, random_state=8), None),
    ("global_random_state", "three", 9, dict(n_estimators=5), 13),
    # the rest of RandomForestClassifier's arguments, on forests of 2 trees (4 for the out-of-bag score), most of
    # them cut to a depth that keeps the records small
    ("class_weight_balanced", "binary", 10,
     dict(n_estimators=2, class_weight="balanced", max_depth=6, random_state=10), None),
    ("class_weight_balanced_no_bootstrap", "three", 11,
     dict(n_estimators=2, class_weight="balanced", bootstrap=False, max_depth=6, random_state=11), None),
    ("class_weight_subsample", "three", 12,
     dict(n_estimators=2, class_weight="balanced_subsample", max_depth=6, random_state=12), None),
    ("class_weight_subsample_no_bootstrap", "binary", 13,
     dict(n_estimators=2, class_weight="balanced_subsample", bootstrap=False, max_depth=6, random_state=13), None),
    ("class_weight_dict_max_samples", "binary", 14,
     dict(n_estimators=2, class_weight={0: 2.5, 1: 0.7}, max_samples=0.5, random_state=14), None),
    ("class_weight_dict_no_bootstrap", "three", 15,
     dict(n_estimators=2, class_weight={0: 1.3, 2: 0.4, 5: 3.1}, bootstrap=False, max_depth=6, random_state=15),
     None),
    ("entropy_class_weight", "three", 16,
     dict(n_estimators=2, criterion="entropy", class_weight="balanced_subsample", max_depth=6, random_state=16),
     None),
    ("max_leaf_nodes_2", "binary", 17, dict(n_estimators=2, max_leaf_nodes=2, random_state=17), None),
    ("max_leaf_nodes_7", "three", 18, dict(n_estimators=2, max_leaf_nodes=7, random_state=18), None),
    ("max_leaf_nodes_50", "binary", 19, dict(n_estimators=2, max_leaf_nodes=50, random_state=19), None),
    ("ccp_alpha", "three", 20, dict(n_estimators=2, ccp_alpha=0.004, random_state=20), None),
    ("ccp_alpha_stump", "binary", 21, dict(n_estimators=2, ccp_alpha=0.5, random_state=21), None),
    ("oob_score", "three", 22, dict(n_estimators=4, oob_score=True, max_depth=5, random_state=22), None),
    ("warm_start", "binary", 23, dict(n_estimators=2, warm_start=True, max_depth=6, random_state=23), None),
    ("monotonic_cst", "binary", 24,
     dict(n_estimators=2, monotonic_cst=[1, 0, 0, -1, 0, 1, 0, 0], max_depth=8, random_state=24), None),
)
# the cases whose sklearn pickles are committed (in PICKLES), one of each kind of tree and forest attribute; the
# tests pickle every case with sklearn where it is installed
PICKLED_CASES = ("class_weight_subsample", "class_weight_dict_max_samples", "max_leaf_nodes_7", "ccp_alpha",
                 "oob_score", "monotonic_cst")
# the fixture whose forest the port refits and pickles, the sha256 of that pickle recorded in PICKLE_RECORD
PICKLED_CASE = "class_weight_dict_max_samples"
PICKLES = OUT / "sklearn_pickles.zip"
PICKLE_RECORD = OUT / "pickle_sha256.json"
# the Shallow2Deep metadata the pickled fixtures carry, as the JAX package's forests do
PICKLE_CONFIG = [["gaussianSmoothing", 0.7], ["structureTensorEigenvalues", [0.7, 1.4]]]


def fixture_data(labels: str, seed: int, n: int = N_SAMPLES):
    """Features (n, 8) float32 and labels (n,) int64 from ``np.random.RandomState(seed)``: 4 normal
    columns, 3 normal columns rounded to halves (ties), a constant column; the second quarter of the
    rows repeats the first quarter's features; labels from a noisy score of two columns, in {0, 1} or {0, 2, 5}."""
    rs = np.random.RandomState(seed)
    continuous = rs.normal(size=(n, 4)).astype(np.float32)
    quantized = (np.round(rs.normal(size=(n, 3)) * 2) / 2).astype(np.float32)
    x = np.concatenate([continuous, quantized, np.full((n, 1), 0.25, np.float32)], axis=1)
    quarter = n // 4
    x[quarter: 2 * quarter] = x[:quarter]
    score = x[:, 0] + 0.5 * x[:, 4] + rs.normal(scale=0.3, size=n)
    if labels == "binary":
        y = (score > 0).astype(np.int64)
    else:
        y = np.array([0, 2, 5], dtype=np.int64)[np.digitize(score, [-0.6, 0.6])]
    return x, y


def data_sha256(x, y) -> str:
    digest = hashlib.sha256()
    for arr in (x, y):
        digest.update(f"{arr.dtype.str}{arr.shape}".encode())
        digest.update(np.ascontiguousarray(arr).tobytes())
    return digest.hexdigest()


def score_labels():
    """The seeded label vectors of the score cases: binary, binary in {2, 5}, multiclass, and a
    multiclass case where y_pred holds a class that y_true lacks and misses one that it has; the
    sample weights."""
    rs = np.random.RandomState(42)
    n = 240
    y = rs.randint(0, 2, n)
    binary = (y, np.where(rs.rand(n) < 0.8, y, 1 - y))
    y = rs.randint(0, 4, n)
    multiclass = (y, np.where(rs.rand(n) < 0.6, y, rs.randint(0, 4, n)))
    y = rs.randint(0, 3, n)
    gaps = (y, np.where(y == 2, 3, np.where(rs.rand(n) < 0.7, y, 1 - y)))
    return {"binary": [v.tolist() for v in binary], "binary25": [(v * 3 + 2).tolist() for v in binary],
            "multiclass": [v.tolist() for v in multiclass], "gaps": [v.tolist() for v in gaps],
            "weights": np.round(rs.uniform(0.1, 3.0, n), 3).tolist()}


W = "weights"  # a keyword argument given as this string takes the seeded sample weights
# (score name, label set, kwargs)
SCORE_CASES = (
    ("accuracy_score", "multiclass", {}), ("accuracy_score", "multiclass", {"normalize": False}),
    ("accuracy_score", "binary", {"sample_weight": W}),
    ("balanced_accuracy_score", "multiclass", {}), ("balanced_accuracy_score", "multiclass", {"adjusted": True}),
    ("balanced_accuracy_score", "binary", {"sample_weight": W}), ("balanced_accuracy_score", "gaps", {}),
    ("precision_score", "binary", {}), ("precision_score", "binary", {"pos_label": 0}),
    ("precision_score", "binary25", {"pos_label": 5}),
    *(("precision_score", "multiclass", {"average": a}) for a in ("micro", "macro", "weighted", None)),
    ("precision_score", "multiclass", {"average": "macro", "labels": [0, 2]}),
    ("precision_score", "gaps", {"average": "macro", "zero_division": 1}),
    ("precision_score", "gaps", {"average": "weighted"}),
    ("recall_score", "binary", {"sample_weight": W}), ("recall_score", "multiclass", {"average": "macro"}),
    ("recall_score", "gaps", {"average": None, "zero_division": 0}),
    ("recall_score", "multiclass", {"average": "weighted", "sample_weight": W}),
    ("f1_score", "binary", {}), ("f1_score", "binary25", {"pos_label": 2}),
    *(("f1_score", "multiclass", {"average": a}) for a in ("micro", "macro", "weighted", None)),
    ("f1_score", "gaps", {"average": "macro"}), ("f1_score", "gaps", {"average": "macro", "zero_division": 1}),
    ("f1_score", "multiclass", {"average": "macro", "labels": [3, 1], "sample_weight": W}),
    ("fbeta_score", "binary", {"beta": 2}), ("fbeta_score", "multiclass", {"beta": 0.5, "average": "macro"}),
    ("jaccard_score", "binary", {}),
    *(("jaccard_score", "multiclass", {"average": a}) for a in ("micro", "macro", "weighted", None)),
    ("jaccard_score", "gaps", {"average": "macro", "sample_weight": W}),
    ("matthews_corrcoef", "binary", {}), ("matthews_corrcoef", "multiclass", {}),
    ("matthews_corrcoef", "gaps", {"sample_weight": W}),
    ("cohen_kappa_score", "multiclass", {}), ("cohen_kappa_score", "multiclass", {"weights": "linear"}),
    ("cohen_kappa_score", "multiclass", {"weights": "quadratic", "sample_weight": W}),
    ("cohen_kappa_score", "gaps", {"labels": [0, 1, 2]}),
    ("hamming_loss", "multiclass", {}), ("hamming_loss", "binary", {"sample_weight": W}),
    ("zero_one_loss", "multiclass", {}), ("zero_one_loss", "multiclass", {"normalize": False}),
    ("zero_one_loss", "binary", {"normalize": False, "sample_weight": W}),
)


SCORE_NAMES = sorted({name for name, _, _ in SCORE_CASES})


def score_kwargs(kwargs, labels):
    """``kwargs`` with the sample weights where they name them."""
    return {k: np.asarray(labels[W]) if v == W else v for k, v in kwargs.items()}


def case_kwargs(recorded: str) -> dict:
    """A case's RandomForestClassifier kwargs from their JSON record (a class_weight dict's keys back as ints)."""
    kwargs = json.loads(recorded)
    if isinstance(kwargs.get("class_weight"), dict):
        kwargs["class_weight"] = {int(k): v for k, v in kwargs["class_weight"].items()}
    return kwargs


def refit(path, n_jobs=1):
    """Refit a forest fixture with the port, no sklearn: the data made anew (their sha256 checked),
    the global seed set where the case sets one. Returns the forest, whether the next global draw
    equals sklearn's (None where the case sets no global seed), and the fit's seconds."""
    from torch_em_tpu_torch.shallow2deep.forest import fit_forest

    with np.load(path) as f:
        kwargs, labels, seed = case_kwargs(str(f["kwargs"])), str(f["labels"]), int(f["data_seed"])
        sha, global_seed, next_draw = str(f["data_sha256"]), int(f["global_seed"]), int(f["next_draw"])
    x, y = fixture_data(labels, seed)
    if data_sha256(x, y) != sha:
        raise AssertionError(f"{path}: the data made from seed {seed} differ from the recorded ones")
    if global_seed >= 0:
        np.random.seed(global_seed)
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # sklearn's warnings on few out-of-bag trees, small bootstraps
        forest = fit_forest(x, y, n_jobs=n_jobs, **kwargs)
    seconds = time.perf_counter() - t
    same_draw = bool(np.random.randint(2 ** 31) == next_draw) if global_seed >= 0 else None
    return forest, same_draw, seconds


def oob_differences(forest, path) -> list:
    """The out-of-bag attributes in which ``forest`` differs from those recorded in a fixture (bitwise)."""
    with np.load(path) as f:
        if "oob_decision_function" not in f.files:
            return []
        recorded = {"oob_score_": f["oob_score"], "oob_decision_function_": f["oob_decision_function"]}
    return [k for k, v in recorded.items() if getattr(forest, k) is None or
            not np.array_equal(np.asarray(getattr(forest, k)).view(np.int64), v.view(np.int64))]


def refit_fixture(path, n_jobs=1):
    """Refit a forest fixture with the port, no sklearn (``refit``). Returns the arrays and out-of-bag
    attributes in which the port's forest differs from sklearn's (none when equal node for node),
    whether the next global draw equals sklearn's (None where the case sets no global seed), and the
    fit's seconds."""
    from torch_em_tpu_torch.shallow2deep.forest import load_forest, node_differences

    forest, same_draw, seconds = refit(path, n_jobs)
    return node_differences(forest, load_forest(str(path))) + oob_differences(forest, path), same_draw, seconds


def pickle_config():
    return [(name, tuple(sigma) if isinstance(sigma, list) else sigma) for name, sigma in PICKLE_CONFIG]


def port_pickle(out_path):
    """Refit ``PICKLED_CASE`` with the port and write its sklearn pickle (``save_forest_pickle``, no sklearn)
    with the Shallow2Deep metadata to ``out_path``. Returns the pickle's sha256."""
    from torch_em_tpu_torch.shallow2deep.forest import save_forest_pickle

    forest, _, _ = refit(OUT / f"{PICKLED_CASE}.npz")
    forest.feature_ndim, forest.feature_config = 2, pickle_config()
    save_forest_pickle(forest, out_path)
    return hashlib.sha256(Path(out_path).read_bytes()).hexdigest()


def read_pickled_fixtures(folder):
    """Unpack the committed sklearn pickles of the fixtures into ``folder`` and read each with the port
    (``load_forest``, no sklearn). Returns, for each case, what differs from its ``.npz`` (the node arrays,
    the out-of-bag attributes, the Shallow2Deep metadata; none when equal) and the seconds of the read."""
    from torch_em_tpu_torch.shallow2deep.forest import load_forest, node_differences

    with zipfile.ZipFile(PICKLES) as archive:
        archive.extractall(folder)
        names = sorted(archive.namelist())
    out = {}
    for name in names:
        case = name[:-len(".pkl")]
        t = time.perf_counter()
        forest = load_forest(os.path.join(folder, name))
        seconds = time.perf_counter() - t
        npz = OUT / f"{case}.npz"
        differences = node_differences(forest, load_forest(str(npz))) + oob_differences(forest, npz)
        if forest.feature_ndim != 2 or forest.feature_config != pickle_config():
            differences.append("feature_config")
        out[case] = (differences, seconds)
    return out


def score_errors(record=OUT / "classification_scores.json"):
    """For each recorded case, its name, arguments and the port's absolute error against sklearn's
    value: the score of ``classification/scores.py`` and 1 minus ``ClassificationMetric``'s value."""
    from torch_em_tpu_torch.classification import ClassificationMetric
    from torch_em_tpu_torch.classification.scores import SCORES

    with open(record) as f:
        recorded = json.load(f)
    labels, out = recorded["labels"], []
    for case in recorded["cases"]:
        y_true, y_pred = (np.asarray(v) for v in labels[case["labels"]])
        kwargs = score_kwargs(case["kwargs"], labels)
        expected = np.asarray(case["value"], dtype=np.float64)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = np.asarray(SCORES[case["name"]](y_true, y_pred, **kwargs), dtype=np.float64)
            metric = 1.0 - np.asarray(ClassificationMetric(case["name"], **kwargs)(y_true, y_pred))
        err = max(float(np.max(np.abs(got - expected))), float(np.max(np.abs(metric - expected)))) \
            if got.shape == expected.shape == metric.shape else float("inf")
        out.append((case["name"], case["kwargs"], case["labels"], err))
    return out


def main():
    import pickle

    import numpy
    import sklearn
    import sklearn.metrics
    from sklearn.ensemble import RandomForestClassifier

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_em_tpu_torch.shallow2deep.forest import forest_from_sklearn, save_forest
    from torch_s2d_forests import fit_forests

    warnings.filterwarnings("ignore")
    OUT.mkdir(parents=True, exist_ok=True)
    pickles = {}
    for name, labels, seed, kwargs, global_seed in FOREST_CASES:
        x, y = fixture_data(labels, seed)
        if global_seed is not None:
            np.random.seed(global_seed)
        rf = RandomForestClassifier(**kwargs).fit(x, y)
        next_draw = np.random.randint(2 ** 31)
        path = OUT / f"{name}.npz"
        save_forest(forest_from_sklearn(rf), str(path))
        with np.load(path) as f:
            arrays = dict(f)
        if kwargs.get("oob_score"):
            arrays.update(oob_score=np.float64(rf.oob_score_), oob_decision_function=rf.oob_decision_function_)
        np.savez_compressed(path, **arrays, kwargs=np.str_(json.dumps(kwargs)), labels=np.str_(labels),
                            data_seed=seed, data_sha256=np.str_(data_sha256(x, y)),
                            global_seed=-1 if global_seed is None else global_seed, next_draw=next_draw,
                            sklearn_version=np.str_(sklearn.__version__), numpy_version=np.str_(numpy.__version__))
        # the pickle as the JAX package writes it: the forest with its Shallow2Deep metadata, pickle.dump's protocol
        rf.feature_ndim, rf.feature_config = 2, pickle_config()
        if name in PICKLED_CASES:
            pickles[f"{name}.pkl"] = pickle.dumps(rf)
        print(f"{name}: {len(rf.estimators_)} trees, {sum(e.tree_.node_count for e in rf.estimators_)} nodes, "
              f"{path.stat().st_size} bytes")
    with zipfile.ZipFile(PICKLES, "w", zipfile.ZIP_DEFLATED, compresslevel=9) as archive:
        for name in sorted(pickles):
            archive.writestr(zipfile.ZipInfo(name, date_time=(2020, 1, 1, 0, 0, 0)), pickles[name],
                             compress_type=zipfile.ZIP_DEFLATED, compresslevel=9)
    print(f"{PICKLES.name}: {len(pickles)} pickles, {PICKLES.stat().st_size} bytes")
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        digest = port_pickle(os.path.join(tmp, "rf.pkl"))
    with open(PICKLE_RECORD, "w") as f:
        json.dump({"case": PICKLED_CASE, "sha256": digest, "numpy_version": numpy.__version__}, f, indent=1)
    print(f"{PICKLE_RECORD.name}: the port's pickle of {PICKLED_CASE}, sha256 {digest}")

    labels = score_labels()
    cases = []
    for name, label_set, kwargs in SCORE_CASES:
        y_true, y_pred = (np.asarray(v) for v in labels[label_set])
        value = getattr(sklearn.metrics, name)(y_true, y_pred, **score_kwargs(kwargs, labels))
        cases.append({"name": name, "labels": label_set, "kwargs": kwargs,
                      "value": np.asarray(value, dtype=np.float64).tolist()})
    with open(OUT / "classification_scores.json", "w") as f:
        json.dump({"sklearn_version": sklearn.__version__, "labels": labels, "cases": cases}, f)
    print(f"classification_scores.json: {len(cases)} cases")

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        _, digest, _ = fit_forests(tmp)
    with open(OUT / "s2d_recipe.json", "w") as f:
        json.dump({"features_sha256": digest, "numpy_version": numpy.__version__,
                   "scipy_version": __import__("scipy").__version__}, f, indent=1)
    print(f"s2d_recipe.json: features sha256 {digest}")


def time_cpu(n=32768, d=28, n_estimators=100):
    """Best-of-three seconds of sklearn's fit and the port's on this CPU, with 1 and 4 threads."""
    from sklearn.ensemble import RandomForestClassifier

    from torch_em_tpu_torch.shallow2deep.forest import fit_forest, forest_from_sklearn, node_differences

    rs = np.random.RandomState(0)
    x = rs.normal(size=(n, d)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] + rs.normal(scale=0.5, size=n) > 0).astype(np.int64)
    fit_forest(x[:64], y[:64], n_estimators=1)  # the build

    def best(fn):
        times = []
        for _ in range(3):
            t = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t)
        return min(times), out

    for threads in (1, 4):
        sk_s, rf = best(lambda: RandomForestClassifier(n_estimators=n_estimators, random_state=0,
                                                       n_jobs=threads).fit(x, y))
        s, forest = best(lambda: fit_forest(x, y, n_estimators=n_estimators, random_state=0, n_jobs=threads))
        print(f"{n_estimators} trees on {n} samples of {d} features, {threads} thread(s): sklearn {sk_s:.3f} s, "
              f"port {s:.3f} s, {len(forest.feature)} nodes, equal node for node "
              f"{not node_differences(forest, forest_from_sklearn(rf))}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--time", action="store_true", help="time sklearn and the port on this CPU; write nothing")
    if parser.parse_args().time:
        time_cpu()
    else:
        main()
