"""sklearn's pickled forests read and written by the port without sklearn (``shallow2deep/sklearn_pickle.py``,
``forest.load_forest`` and ``forest.save_forest_pickle``), held against scikit-learn 1.9, which this machine has.

- Reading: sklearn's pickle of every fixture case of ``scripts/make_forest_fixtures.py`` (fitted here, with the
  Shallow2Deep metadata) is read in a subprocess where importing sklearn fails; each forest equals sklearn's node
  for node, predicts bitwise as sklearn's and keeps its metadata and out-of-bag arrays. The committed pickles read
  as their ``.npz`` records and as sklearn reads them. Pickles of protocols 3 and 5, of numpy 1's module names and
  of a ``RandomState`` argument read too.
- Writing: the port's pickle of every case, written in a subprocess where importing sklearn fails, loads through a
  plain ``pickle.load`` with no ``InconsistentVersionWarning``, holds the state of ``forest_to_sklearn``'s forest
  pickled by sklearn, key for key, and predicts bitwise as sklearn's own fit; its bytes reproduce the recorded
  sha256.
- sklearn before 1.4 kept weighted counts in ``values`` and before 1.3 had no ``missing_go_to_left``: a pickle
  built in that layout and stamped 1.3.2 reads as the same class fractions, whatever sklearn is installed.
- The restricted unpickler refuses a global a forest does not hold, before it runs.
- The JAX package's own Shallow2Deep readers accept a folder of the port's pickles and predict as with sklearn's.
"""

import hashlib
import importlib
import io
import json
import os
import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
from sklearn.ensemble import RandomForestClassifier
from sklearn.exceptions import InconsistentVersionWarning
from sklearn.tree._tree import Tree

from torch_em_tpu.shallow2deep import shallow2deep_dataset as jax_dataset
from torch_em_tpu.shallow2deep import shallow2deep_eval as jax_eval
from torch_em_tpu_torch.shallow2deep import (
    fit_forest, forest_from_sklearn, forest_to_sklearn, load_forest, node_differences, save_forest, save_forest_pickle,
    sklearn_pickle,
)
from torch_em_tpu_torch.utils.test import make_mito_image

# the package exports the function prepare_shallow2deep under the module's name
port_prepare_module = importlib.import_module("torch_em_tpu_torch.shallow2deep.prepare_shallow2deep")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import make_forest_fixtures as fixtures  # noqa: E402

CASES = [case[0] for case in fixtures.FOREST_CASES]
# the case whose pickles also carry an advanced-path forest's training data
TRAIN_CASE, TRAIN_ROWS = "max_leaf_nodes_2", 40
TEST_FEATURES = np.random.RandomState(77).normal(size=(700, 8))  # float64, which both sides cast to float32


def _no_sklearn(code: str, *args) -> str:
    """Run ``code`` in a Python subprocess in which importing sklearn fails; returns its standard output."""
    program = ("import sys\nsys.modules['sklearn'] = None\nsys.path.insert(0, 'scripts')\n" + code +
               "\nassert sys.modules['sklearn'] is None and not [m for m in sys.modules if m.startswith('sklearn.')]\n")
    proc = subprocess.run([sys.executable, "-c", program, *map(str, args)], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _case(name):
    return next(case for case in fixtures.FOREST_CASES if case[0] == name)


def _sklearn_fit(name):
    """sklearn's forest of a fixture case, with the Shallow2Deep metadata the JAX package gives it."""
    _, labels, seed, kwargs, global_seed = _case(name)
    x, y = fixtures.fixture_data(labels, seed)
    if global_seed is not None:
        np.random.seed(global_seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        rf = RandomForestClassifier(**kwargs).fit(x, y)
    rf.feature_ndim, rf.feature_config = 2, fixtures.pickle_config()
    if name == TRAIN_CASE:
        rf.train_features, rf.train_labels = x[:TRAIN_ROWS], y[:TRAIN_ROWS].astype(np.int8)
    return rf


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _same_state(a, b, where="forest"):
    """Assert that two unpickled sklearn objects hold the same state: the same attributes in the same order, arrays
    of the same dtype, shape and bytes, trees of the same constructor arguments and state."""
    assert type(a) is type(b), where
    if isinstance(a, np.ndarray):
        assert _bitwise(a, b), where
    elif isinstance(a, Tree):
        ra, rb = a.__reduce__(), b.__reduce__()
        assert ra[1][0] == rb[1][0] and _bitwise(ra[1][1], rb[1][1]) and ra[1][2] == rb[1][2], where
        _same_state(ra[2], rb[2], where + ".tree_")
    elif isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for key in a:
            _same_state(a[key], b[key], f"{where}.{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _same_state(u, v, f"{where}[{i}]")
    elif hasattr(a, "__dict__") and type(a).__module__.startswith("sklearn."):
        _same_state(a.__dict__, b.__dict__, where)
    else:
        assert a == b, (where, a, b)


@pytest.fixture(scope="module")
def read_without_sklearn(tmp_path_factory):
    """sklearn's pickles of every case, and what the port read from them with sklearn blocked: each forest as
    ``.npz``, its predictions on TEST_FEATURES and its metadata."""
    folder = tmp_path_factory.mktemp("sklearn_pickles")
    fitted = {}
    for name in CASES:
        fitted[name] = _sklearn_fit(name)
        with open(folder / f"{name}.pkl", "wb") as f:
            pickle.dump(fitted[name], f)
    np.save(folder / "test.npy", TEST_FEATURES)
    _no_sklearn("""
import json, os, numpy as np
from torch_em_tpu_torch.shallow2deep import load_forest, save_forest
folder = sys.argv[1]
test = np.load(os.path.join(folder, "test.npy"))
for name in sorted(os.listdir(folder)):
    if not name.endswith(".pkl"):
        continue
    forest = load_forest(os.path.join(folder, name))
    stem = os.path.join(folder, name[:-4])
    save_forest(forest, stem + ".npz")
    np.save(stem + "_proba.npy", forest.predict_proba(test))
    extras = {"feature_ndim": forest.feature_ndim, "feature_config": forest.feature_config,
              "oob_score": forest.oob_score_, "params": sorted(forest.params), "seeds": forest.tree_seeds}
    for key in ("oob_decision_function_", "train_features", "train_labels"):
        if getattr(forest, key) is not None:
            np.save(stem + "_" + key + ".npy", getattr(forest, key))
    with open(stem + ".json", "w") as f:
        json.dump(extras, f)
""", folder)
    return folder, fitted


@pytest.mark.parametrize("case", CASES)
def test_sklearn_pickles_read_without_sklearn(read_without_sklearn, case):
    folder, fitted = read_without_sklearn
    rf = fitted[case]
    forest = load_forest(str(folder / f"{case}.npz"))
    assert forest.missing_go_to_left is not None
    assert node_differences(forest, forest_from_sklearn(rf)) == []
    assert _bitwise(np.load(folder / f"{case}_proba.npy"), rf.predict_proba(TEST_FEATURES))
    with open(folder / f"{case}.json") as f:
        extras = json.load(f)
    config = [(name, tuple(sigma) if isinstance(sigma, list) else sigma) for name, sigma in extras["feature_config"]]
    assert extras["feature_ndim"] == 2 and config == fixtures.pickle_config()
    assert extras["seeds"] == [e.random_state for e in rf.estimators_]
    assert extras["params"] == sorted(rf.get_params())
    if hasattr(rf, "oob_score_"):
        assert extras["oob_score"] == rf.oob_score_
        assert _bitwise(np.load(folder / f"{case}_oob_decision_function_.npy"), rf.oob_decision_function_)
    else:
        assert extras["oob_score"] is None
    if case == TRAIN_CASE:
        assert _bitwise(np.load(folder / f"{case}_train_features.npy"), rf.train_features)
        assert _bitwise(np.load(folder / f"{case}_train_labels.npy"), rf.train_labels)


@pytest.fixture(scope="module")
def written_without_sklearn(tmp_path_factory):
    """The port's pickle of every case, refitted and written with sklearn blocked, and the sha256 of the pickle of
    ``fixtures.PICKLED_CASE`` (twice)."""
    folder = tmp_path_factory.mktemp("port_pickles")
    out = _no_sklearn(f"""
import os, numpy as np
import make_forest_fixtures as fixtures
from torch_em_tpu_torch.shallow2deep import save_forest_pickle
folder = sys.argv[1]
for name, labels, seed, _, _ in fixtures.FOREST_CASES:
    forest, _, _ = fixtures.refit(fixtures.OUT / (name + ".npz"))
    forest.feature_ndim, forest.feature_config = 2, fixtures.pickle_config()
    if name == {TRAIN_CASE!r}:
        x, y = fixtures.fixture_data(labels, seed)
        forest.train_features, forest.train_labels = x[:{TRAIN_ROWS}], y[:{TRAIN_ROWS}].astype(np.int8)
    save_forest_pickle(forest, os.path.join(folder, name + ".pkl"))
print(fixtures.port_pickle(os.path.join(folder, "a")), fixtures.port_pickle(os.path.join(folder, "b")))
""", folder)
    return folder, out.split()


@pytest.mark.parametrize("case", CASES)
def test_port_pickles_load_in_sklearn(written_without_sklearn, case):
    folder, _ = written_without_sklearn
    with warnings.catch_warnings():
        warnings.simplefilter("error", InconsistentVersionWarning)
        with open(folder / f"{case}.pkl", "rb") as f:
            loaded = pickle.load(f)
    assert type(loaded) is RandomForestClassifier
    # forest_to_sklearn's forest of the same refitted trees, pickled and loaded by sklearn
    forest, _, _ = fixtures.refit(fixtures.OUT / f"{case}.npz")
    forest.feature_ndim, forest.feature_config = 2, fixtures.pickle_config()
    rf = _sklearn_fit(case)
    if case == TRAIN_CASE:
        forest.train_features, forest.train_labels = rf.train_features, rf.train_labels
    reference = pickle.loads(pickle.dumps(forest_to_sklearn(forest)))
    _same_state(loaded, reference)
    assert _bitwise(loaded.predict_proba(TEST_FEATURES), rf.predict_proba(TEST_FEATURES))
    assert np.array_equal(loaded.predict(TEST_FEATURES), rf.predict(TEST_FEATURES))
    if hasattr(rf, "oob_score_"):
        assert loaded.oob_score_ == rf.oob_score_ and _bitwise(loaded.oob_decision_function_,
                                                               rf.oob_decision_function_)


def test_port_pickle_bytes_are_recorded(written_without_sklearn):
    _, digests = written_without_sklearn
    with open(fixtures.PICKLE_RECORD) as f:
        record = json.load(f)
    assert record["case"] == fixtures.PICKLED_CASE and digests == [record["sha256"]] * 2


def test_committed_pickles_read_as_recorded(tmp_path):
    """The committed sklearn pickles (which phase 16d reads on the card) equal their .npz records through the
    port's reader, and sklearn's own reading of them."""
    results = fixtures.read_pickled_fixtures(tmp_path)
    assert sorted(results) == sorted(fixtures.PICKLED_CASES)
    assert {name: differences for name, (differences, _) in results.items()} == {
        name: [] for name in fixtures.PICKLED_CASES}
    for name in fixtures.PICKLED_CASES:
        with open(tmp_path / f"{name}.pkl", "rb") as f:
            rf = pickle.load(f)
        assert node_differences(load_forest(str(tmp_path / f"{name}.pkl")), forest_from_sklearn(rf)) == []


def test_other_pickle_layouts_read(tmp_path, monkeypatch):
    """Protocols 3 and 5, a random_state given as a RandomState, and numpy 1's module names."""
    x, y = fixtures.fixture_data("three", 40)
    rf = RandomForestClassifier(n_estimators=3, max_depth=4, random_state=np.random.RandomState(4)).fit(x, y)
    expected = forest_from_sklearn(rf)
    for protocol in (3, 5):
        path = tmp_path / f"rf{protocol}.pkl"
        path.write_bytes(pickle.dumps(rf, protocol=protocol))
        assert node_differences(load_forest(str(path)), expected) == []
    # numpy < 2 wrote numpy.core.multiarray
    for function, (module, name) in list(sklearn_pickle.GLOBAL_NAMES.items()):
        if module == "numpy._core.multiarray":
            monkeypatch.setitem(sklearn_pickle.GLOBAL_NAMES, function, ("numpy.core.multiarray", name))
    stub = sklearn_pickle.load(io.BytesIO(pickle.dumps(rf)))
    stub.random_state = 4  # the writer names no RandomState
    data = sklearn_pickle.dumps(stub)
    assert b"numpy.core.multiarray" in data and b"numpy._core" not in data
    path = tmp_path / "numpy1.pkl"
    path.write_bytes(data)
    assert node_differences(load_forest(str(path)), expected) == []


def _sklearn_13(rf, version="1.3.2") -> bytes:
    """A pickle of ``rf`` in the layout of sklearn before 1.4 (weighted class counts in ``values``) and before 1.3
    (no ``missing_go_to_left``), stamped ``version``: sklearn's pickle read into the stand-ins and rewritten."""
    stub = sklearn_pickle.load(io.BytesIO(pickle.dumps(rf)))
    fields = [f for f in stub.estimators_[0].tree_.nodes.dtype.names if f != "missing_go_to_left"]
    old_dtype = np.dtype([(f, stub.estimators_[0].tree_.nodes.dtype.fields[f][0]) for f in fields])
    for estimator in [stub, *stub.estimators_]:
        estimator._sklearn_version = version
    for estimator in stub.estimators_:
        state = estimator.tree_.__getstate__()
        nodes = np.zeros(len(state["nodes"]), dtype=old_dtype)
        for f in fields:
            nodes[f] = state["nodes"][f]
        # the weighted counts of each class: integers, since the bootstrap's weights are
        counts = np.round(state["values"] * state["nodes"]["weighted_n_node_samples"][:, None, None])
        estimator.tree_.__setstate__(dict(state, nodes=nodes, values=counts))
    return sklearn_pickle.dumps(stub)


def test_sklearn_13_layout_reads_as_fractions(tmp_path):
    """The counts are told from the fractions by the pickle's _sklearn_version, not by the installed sklearn: the
    1.3.2 layout gives sklearn 1.9's fractions bitwise, the same counts stamped 1.9.0 do not."""
    x, y = fixtures.fixture_data("three", 41)
    rf = RandomForestClassifier(n_estimators=4, random_state=41).fit(x, y)
    expected = forest_from_sklearn(rf)
    path = tmp_path / "rf13.pkl"
    path.write_bytes(_sklearn_13(rf))
    got = load_forest(str(path))
    assert got.missing_go_to_left is None and node_differences(got, expected) == []
    assert _bitwise(got.value, expected.value) and _bitwise(got.predict_proba(x), rf.predict_proba(x))
    path.write_bytes(_sklearn_13(rf, version="1.9.0"))
    assert "value" in node_differences(load_forest(str(path)), expected)


def test_restricted_unpickler_refuses_other_globals(tmp_path):
    marker = tmp_path / "ran"

    class Payload:
        def __reduce__(self):
            return os.system, (f"touch {marker}",)

    path = tmp_path / "rf.pkl"
    path.write_bytes(pickle.dumps({"estimators_": [Payload()]}))
    with pytest.raises(pickle.UnpicklingError, match=r"posix\.system"):
        load_forest(str(path))
    assert not marker.exists()
    path.write_bytes(pickle.dumps(eval))
    with pytest.raises(pickle.UnpicklingError, match=r"builtins\.eval"):
        sklearn_pickle.load(open(path, "rb"))


def test_writer_refuses_a_global_it_cannot_name(tmp_path):
    x, y = fixtures.fixture_data("binary", 42, n=200)
    with pytest.warns(UserWarning, match="OOB"):
        forest = fit_forest(x, y, n_estimators=4, oob_score=lambda y_true, y_pred: 0.5, random_state=0)
    with pytest.raises(pickle.PicklingError, match="holds no global"):
        save_forest_pickle(forest, tmp_path / "rf.pkl")


def test_export_forests_writes_the_missing_file(tmp_path):
    x, y = fixtures.fixture_data("binary", 43, n=300)
    forest = fit_forest(x, y, n_estimators=3, random_state=43)
    forest.feature_ndim, forest.feature_config = 2, fixtures.pickle_config()
    save_forest(forest, tmp_path / "rf_0000.npz")
    save_forest_pickle(forest, tmp_path / "rf_0001.pkl")
    save_forest(forest, tmp_path / "rf_0002.npz")
    save_forest_pickle(forest, tmp_path / "rf_0002.pkl")
    written = port_prepare_module.export_forests(str(tmp_path))
    assert written == [str(tmp_path / "rf_0000.pkl"), str(tmp_path / "rf_0001.npz")]
    for path in written:
        assert node_differences(load_forest(path), forest) == []
    assert port_prepare_module.export_forests(str(tmp_path)) == []


@pytest.fixture(scope="module")
def s2d_folders(tmp_path_factory):
    """The port's prepare_shallow2deep with sklearn blocked (rf_XXXX.pkl and .npz), and a folder of sklearn's
    pickles of the same forests (forest_to_sklearn)."""
    folder = tmp_path_factory.mktemp("s2d")
    rng = np.random.default_rng(0)
    raw = np.stack([make_mito_image(rng, 64)[0] for _ in range(3)])
    np.save(folder / "raw.npy", raw)
    np.save(folder / "labels.npy", (raw < 0.45).astype(np.uint32))
    _no_sklearn("""
import numpy as np
from torch_em_tpu_torch.shallow2deep import ForegroundTransform, prepare_shallow2deep
folder = sys.argv[1]
np.random.seed(2)
prepare_shallow2deep(folder + "/raw.npy", None, folder + "/labels.npy", None, (1, 32, 32), (1, 48, 48), 3, 1,
                     folder + "/port", 2, label_transform=ForegroundTransform(ndim=2), n_estimators=4,
                     random_state=0, class_weight="balanced_subsample", max_leaf_nodes=40)
""", folder)
    os.makedirs(folder / "sklearn")
    for i in range(3):
        with open(folder / "sklearn" / f"rf_{i:04d}.pkl", "wb") as f:
            pickle.dump(forest_to_sklearn(load_forest(str(folder / "port" / f"rf_{i:04d}.npz"))), f)
    return folder, raw


def test_jax_package_reads_port_pickles(s2d_folders):
    """The JAX package's visualize_pretrained_rfs and Shallow2DeepDataset (glob("*.pkl"), pickle.load) accept the
    port's pickles and predict as with sklearn's pickles of the same forests."""
    folder, raw = s2d_folders
    assert sorted(os.listdir(folder / "port")) == sorted([f"rf_{i:04d}{ext}" for i in range(3)
                                                          for ext in (".npz", ".pkl")])
    port = jax_eval.visualize_pretrained_rfs(str(folder / "port"), raw[0], 3)
    expected = jax_eval.visualize_pretrained_rfs(str(folder / "sklearn"), raw[0], 3)
    assert sorted(port) == sorted(expected) == [f"rf_{i:04d}.pkl" for i in range(3)]
    for name in port:
        assert _bitwise(port[name], expected[name]) and port[name].shape == (64, 64, 2)
    items = []
    for sub in ("port", "sklearn"):
        paths = sorted(str(folder / sub / f"rf_{i:04d}.pkl") for i in range(3))
        ds = jax_dataset.get_shallow2deep_dataset(str(folder / "raw.npy"), None, str(folder / "labels.npy"), None,
                                                  rf_paths=paths, patch_shape=(1, 32, 32), ndim=2, n_samples=4)
        np.random.seed(9)
        items.append([np.asarray(ds[i][0]) for i in range(4)])
    assert all(_bitwise(a, b) for a, b in zip(*items))


def test_pickle_digest_is_of_the_bytes(tmp_path):
    """save_forest_pickle writes dumps() of the stand-ins: equal forests give equal bytes."""
    x, y = fixtures.fixture_data("three", 44, n=300)
    paths = [tmp_path / "a.pkl", tmp_path / "b.pkl"]
    for path in paths:
        save_forest_pickle(fit_forest(x, y, n_estimators=3, random_state=44, class_weight="balanced"), path)
    digests = {hashlib.sha256(p.read_bytes()).hexdigest() for p in paths}
    assert len(digests) == 1
