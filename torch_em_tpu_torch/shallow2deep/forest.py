"""A random forest as plain arrays: fitted natively, evaluated in numpy.

The JAX package, like torch-em, fits its Shallow2Deep forests with scikit-learn's
``RandomForestClassifier``, keeps them pickled and predicts with sklearn. The
machine with the card has no sklearn, so the port fits, keeps and evaluates a
forest itself:

- ``Forest`` holds every tree's ``feature``, ``threshold``,
  ``children_left``, ``children_right`` (-1 at a leaf), class ``value`` (the
  fraction of each class in the node) and, where known, ``impurity``,
  ``n_node_samples`` and ``weighted_n_node_samples``, concatenated in
  estimator order with ``node_offsets``, and the forest's ``classes_``,
  ``n_features_in_`` and the Shallow2Deep metadata ``feature_ndim`` and
  ``feature_config``;
- ``fit_forest(features, labels, **rf_kwargs)`` fits one with
  ``RandomForestClassifier``'s arguments and defaults and gives sklearn 1.9's
  trees node for node: the random draws are numpy's, as sklearn makes them
  (one seed per tree from ``random_state``, the bootstrap by the legacy
  ``RandomState.randint``), the trees are grown by ``ops/native/forest.cpp``
  on ``n_jobs`` threads;
- ``forest_from_sklearn(rf)`` reads the arrays of a fitted sklearn forest,
  ``forest_to_sklearn(forest)`` builds a sklearn forest from them (where
  sklearn is installed), which predicts as the one that was fitted;
- ``save_forest(forest, path)`` writes an ``.npz`` file, which
  ``load_forest(path)`` reads without sklearn; ``load_forest`` reads a
  ``.pkl`` file through sklearn, and raises an ``ImportError`` naming
  scikit-learn where it is missing.

``Forest.predict_proba`` equals sklearn's: the features are cast to float32
and compared as ``x <= threshold`` against the float64 thresholds (in float64,
as sklearn's trees compare), each tree contributes the value of the leaf a
sample reaches, and the sum over the trees, taken in estimator order, is
divided by their number. All samples of all trees descend together, one level
per step.
"""

import ctypes
import json
import numbers
import os
import pickle
import warnings
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["Forest", "fit_forest", "forest_from_sklearn", "forest_to_sklearn", "save_forest", "load_forest",
           "node_differences"]

# the node arrays that a fitted forest may carry beside those that predict
NODE_STATISTICS = ("impurity", "n_node_samples", "weighted_n_node_samples")


def _sklearn_missing(what: str) -> ImportError:
    return ImportError(f"{what} needs scikit-learn (sklearn), which is not installed; "
                       "a forest saved as .npz (save_forest) loads without it")


def _config_from_json(config):
    """The (filter name, sigma) pairs of a feature config, with a list sigma back as a tuple."""
    if config is None:
        return None
    return [(name, tuple(sigma) if isinstance(sigma, list) else sigma) for name, sigma in config]


class Forest:
    """A fitted random forest classifier's trees as arrays, with sklearn's ``predict_proba``."""

    def __init__(self, node_offsets, feature, threshold, children_left, children_right, value, classes,
                 n_features_in: int, feature_ndim: Optional[int] = None, feature_config=None, impurity=None,
                 n_node_samples=None, weighted_n_node_samples=None):
        self.node_offsets = np.asarray(node_offsets, dtype=np.int64)
        self.feature = np.asarray(feature, dtype=np.int64)
        self.threshold = np.asarray(threshold, dtype=np.float64)
        self.children_left = np.asarray(children_left, dtype=np.int64)
        self.children_right = np.asarray(children_right, dtype=np.int64)
        self.value = np.asarray(value, dtype=np.float64)
        self.classes_ = np.asarray(classes)
        self.n_features_in_ = int(n_features_in)
        self.feature_ndim = feature_ndim
        self.feature_config = _config_from_json(feature_config)
        self.impurity = None if impurity is None else np.asarray(impurity, dtype=np.float64)
        self.n_node_samples = None if n_node_samples is None else np.asarray(n_node_samples, dtype=np.int64)
        self.weighted_n_node_samples = (None if weighted_n_node_samples is None
                                        else np.asarray(weighted_n_node_samples, dtype=np.float64))
        # fit_forest's arguments and each tree's seed, which forest_to_sklearn gives the sklearn forest
        self.params, self.tree_seeds = None, None
        if self.value.shape != (len(self.feature), len(self.classes_)):
            raise ValueError(f"value of shape {self.value.shape} for {len(self.feature)} nodes and "
                             f"{len(self.classes_)} classes")
        # the children as indices into the concatenated nodes (-1 at a leaf)
        base = np.repeat(self.node_offsets[:-1], np.diff(self.node_offsets))
        self._left = np.where(self.children_left >= 0, self.children_left + base, -1)
        self._right = np.where(self.children_right >= 0, self.children_right + base, -1)

    @property
    def n_estimators(self) -> int:
        return len(self.node_offsets) - 1

    @property
    def n_classes_(self) -> int:
        return len(self.classes_)

    def apply(self, features) -> np.ndarray:
        """The leaf (an index into the concatenated nodes) that each sample reaches in each
        tree, of shape (n_estimators, n_samples)."""
        x = np.asarray(features, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.n_features_in_:
            raise ValueError(f"features of shape {x.shape} for a forest of {self.n_features_in_} features")
        n, flat = len(x), np.ascontiguousarray(x).ravel()
        node = np.repeat(self.node_offsets[:-1], n)
        row = np.tile(np.arange(n, dtype=np.int64) * self.n_features_in_, self.n_estimators)
        active = np.flatnonzero(self._left[node] >= 0)
        while active.size:
            nd = node[active]
            # float32 features against float64 thresholds, compared in float64
            go_left = flat[row[active] + self.feature[nd]] <= self.threshold[nd]
            nxt = np.where(go_left, self._left[nd], self._right[nd])
            node[active] = nxt
            active = active[self._left[nxt] >= 0]
        return node.reshape(self.n_estimators, n)

    def predict_proba(self, features) -> np.ndarray:
        """Class probabilities (n_samples, n_classes) in float64: the trees' leaf values summed
        in estimator order, over the number of trees."""
        leaves = self.apply(features)
        proba = np.zeros((leaves.shape[1], self.n_classes_), dtype=np.float64)
        for tree_leaves in leaves:
            proba += self.value[tree_leaves]
        proba /= self.n_estimators
        return proba


def _sklearn_value_is_fraction() -> bool:
    """Whether this sklearn's trees store class fractions (1.4 and later) rather than counts."""
    import sklearn

    major, minor = (int(p) for p in sklearn.__version__.split(".")[:2])
    return (major, minor) >= (1, 4)


def forest_from_sklearn(rf) -> Forest:
    """The arrays of a fitted sklearn ``RandomForestClassifier`` (one output), with its
    ``feature_ndim`` and ``feature_config`` where it has them."""
    if getattr(rf, "n_outputs_", 1) != 1:
        raise ValueError("only forests of one output are supported")
    fraction = _sklearn_value_is_fraction()
    n_classes = len(rf.classes_)
    names = ("feature", "threshold", "children_left", "children_right") + NODE_STATISTICS
    offsets, parts = [0], {k: [] for k in names + ("value",)}
    for estimator in rf.estimators_:
        tree = estimator.tree_
        value = np.asarray(tree.value[:, 0, :n_classes], dtype=np.float64)
        if not fraction:  # counts: normalised as sklearn's predict_proba did before 1.4
            normalizer = value.sum(axis=1)[:, None]
            normalizer[normalizer == 0.0] = 1.0
            value = value / normalizer
        for name in names:
            parts[name].append(getattr(tree, name))
        parts["value"].append(value)
        offsets.append(offsets[-1] + tree.node_count)
    arrays = {k: np.concatenate(v) for k, v in parts.items()}
    return Forest(offsets, arrays["feature"], arrays["threshold"], arrays["children_left"], arrays["children_right"],
                  arrays["value"], rf.classes_, rf.n_features_in_, getattr(rf, "feature_ndim", None),
                  getattr(rf, "feature_config", None), *(arrays[k] for k in NODE_STATISTICS))


# RandomForestClassifier's arguments and defaults in sklearn 1.9
FIT_DEFAULTS = dict(
    n_estimators=100, criterion="gini", max_depth=None, min_samples_split=2, min_samples_leaf=1,
    min_weight_fraction_leaf=0.0, max_features="sqrt", max_leaf_nodes=None, min_impurity_decrease=0.0,
    bootstrap=True, oob_score=False, n_jobs=None, random_state=None, verbose=0, warm_start=False,
    class_weight=None, ccp_alpha=0.0, max_samples=None, monotonic_cst=None,
)
# the arguments fit_forest takes only at their defaults
NOT_IMPLEMENTED = ("max_leaf_nodes", "class_weight", "oob_score", "warm_start", "ccp_alpha", "monotonic_cst")
MAX_INT = np.iinfo(np.int32).max
RAND_R_MAX = 2147483647  # sklearn/utils/_random.pxd
# the bootstrap counts of at most this many bytes are drawn at once (more trees go in several calls)
COUNT_BYTES = 256 << 20


def _check_random_state(seed) -> np.random.RandomState:
    """sklearn's ``check_random_state``: the global ``RandomState`` for None, a new one for an
    int, a given one as it is."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a numpy.random.RandomState instance")


def _n_jobs(n_jobs) -> int:
    """joblib's count of workers: None is 1, -1 every core, -2 all but one, and so on."""
    if n_jobs is None:
        return 1
    if n_jobs == 0:
        raise ValueError("n_jobs == 0 has no meaning")
    return int(n_jobs) if n_jobs > 0 else max(1, (os.cpu_count() or 1) + 1 + int(n_jobs))


def _min_samples(value, name, n_samples, low):
    if isinstance(value, numbers.Integral) and not isinstance(value, bool):
        if value < low:
            raise ValueError(f"{name} must be an int of at least {low} or a float in (0, 1), got {value}")
        return int(value)
    if not 0.0 < value <= 1.0:
        raise ValueError(f"{name} must be an int of at least {low} or a float in (0, 1), got {value}")
    return int(np.ceil(value * n_samples))


def _max_features(value, n_features) -> int:
    """tree/_classes.py: the number of features drawn at each split."""
    if isinstance(value, str):
        if value == "sqrt":
            return max(1, int(np.sqrt(n_features)))
        if value == "log2":
            return max(1, int(np.log2(n_features)))
        raise ValueError(f"max_features must be 'sqrt', 'log2', an int, a float or None, got {value!r}")
    if value is None:
        return n_features
    if isinstance(value, numbers.Integral):
        if value < 1:
            raise ValueError(f"max_features must be at least 1, got {value}")
        return int(value)
    if not 0.0 < value <= 1.0:
        raise ValueError(f"a float max_features must be in (0, 1], got {value}")
    return max(1, int(value * n_features))


def _n_samples_bootstrap(n_samples, max_samples) -> int:
    """ensemble/_bootstrap.py:_get_n_samples_bootstrap without sample weights."""
    if max_samples is None:
        return n_samples
    if isinstance(max_samples, numbers.Integral):
        if max_samples < 1:
            raise ValueError(f"max_samples must be at least 1, got {max_samples}")
        return int(max_samples)
    if not max_samples > 0.0:
        raise ValueError(f"max_samples must be above 0, got {max_samples}")
    n = max(int(max_samples * n_samples), 1)
    if n < max(10, n_samples ** (1 / 3)):
        warnings.warn(f"Using the fractional value max_samples={max_samples} when the number of samples is "
                      f"{n_samples} results in a low number ({n}) of bootstrap samples. We recommend passing "
                      "`max_samples` as an integer instead.")
    return n


def fit_forest(features, labels, **rf_kwargs) -> Forest:
    """A random forest classifier fitted on ``features`` (n_samples, n_features) and ``labels``
    (n_samples,), equal node for node to sklearn 1.9's
    ``RandomForestClassifier(**rf_kwargs).fit(features, labels)``: the same trees in the same
    order, with the same features, thresholds, children, class fractions, impurities and sample
    counts. ``rf_kwargs`` are sklearn's arguments with sklearn's defaults; ``random_state`` None
    draws from the global ``np.random`` as sklearn does. ``n_jobs`` threads grow the trees, which
    do not depend on their number; ``verbose`` is ignored. ``max_leaf_nodes``, ``class_weight``,
    ``oob_score``, ``warm_start``, ``ccp_alpha`` and ``monotonic_cst`` raise
    ``NotImplementedError`` unless left at their defaults. The features are cast to float32, as
    sklearn casts them, and must be dense and finite."""
    from ..ops.native import load_forest_library

    unknown = sorted(set(rf_kwargs) - set(FIT_DEFAULTS))
    if unknown:
        raise TypeError(f"fit_forest got arguments that RandomForestClassifier does not take: {unknown}")
    kw = {**FIT_DEFAULTS, **rf_kwargs}
    for name in NOT_IMPLEMENTED:
        value = kw[name]
        at_default = value == 0.0 if name == "ccp_alpha" else (value is False if name in ("oob_score", "warm_start")
                                                                else value is None)
        if not at_default:
            raise NotImplementedError(f"fit_forest does not implement {name}={value!r}")
    criterion = {"gini": 0, "entropy": 1, "log_loss": 1}.get(kw["criterion"])
    if criterion is None:
        raise ValueError(f"criterion must be 'gini', 'entropy' or 'log_loss', got {kw['criterion']!r}")
    n_estimators = kw["n_estimators"]
    if not isinstance(n_estimators, numbers.Integral) or n_estimators < 1:
        raise ValueError(f"n_estimators must be an int of at least 1, got {n_estimators!r}")
    if not 0.0 <= kw["min_weight_fraction_leaf"] <= 0.5:
        raise ValueError(f"min_weight_fraction_leaf must be in [0, 0.5], got {kw['min_weight_fraction_leaf']}")
    if not kw["min_impurity_decrease"] >= 0.0:
        raise ValueError(f"min_impurity_decrease must be at least 0, got {kw['min_impurity_decrease']}")
    if kw["max_depth"] is not None and kw["max_depth"] < 1:
        raise ValueError(f"max_depth must be at least 1 or None, got {kw['max_depth']}")
    if not kw["bootstrap"] and kw["max_samples"] is not None:
        raise ValueError("`max_sample` cannot be set if `bootstrap=False`. Either switch to `bootstrap=True` or set "
                         "`max_sample=None`.")

    x = np.asarray(features, dtype=np.float32)
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"fit_forest takes features of shape (n_samples, n_features), got {x.shape}")
    if not np.isfinite(x).all():
        raise ValueError("fit_forest takes finite features (no NaN or infinity)")
    y = np.asarray(labels)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y.ravel()
    if y.shape != (len(x),):
        raise ValueError(f"labels of shape {np.shape(labels)} for {len(x)} samples")
    if y.dtype.kind == "f" and not np.array_equal(y, np.round(y)):
        raise ValueError("Unknown label type: continuous. fit_forest takes class labels")
    classes, encoded = np.unique(y, return_inverse=True)
    n_samples, n_features = x.shape

    random_state = _check_random_state(kw["random_state"])
    # ensemble/_base.py:_set_random_states, one draw per tree in estimator order
    seeds = [random_state.randint(MAX_INT) for _ in range(n_estimators)]
    min_samples_leaf = _min_samples(kw["min_samples_leaf"], "min_samples_leaf", n_samples, 1)
    min_samples_split = max(2, _min_samples(kw["min_samples_split"], "min_samples_split", n_samples, 2))
    min_samples_split = max(min_samples_split, 2 * min_samples_leaf)
    n_bootstrap = _n_samples_bootstrap(n_samples, kw["max_samples"]) if kw["bootstrap"] else None
    # the bootstrap counts are the trees' sample weights, whose sum weighs min_weight_fraction_leaf
    min_weight_leaf = kw["min_weight_fraction_leaf"] * (n_samples if n_bootstrap is None else float(n_bootstrap))
    threads = _n_jobs(kw["n_jobs"])
    max_depth = MAX_INT if kw["max_depth"] is None else int(kw["max_depth"])

    lib = load_forest_library()
    columns = np.ascontiguousarray(x.T)
    y32 = np.ascontiguousarray(encoded.reshape(-1), dtype=np.int32)
    chunk = max(threads, COUNT_BYTES // (4 * n_samples)) if kw["bootstrap"] else n_estimators
    trees = []
    for first in range(0, n_estimators, chunk):
        part = seeds[first:first + chunk]
        counts = None
        if kw["bootstrap"]:
            # _forest.py:_generate_sample_indices and _parallel_build_trees
            counts = np.stack([np.bincount(np.random.RandomState(s).randint(0, n_samples, n_bootstrap),
                                           minlength=n_samples) for s in part]).astype(np.int32)
        # _splitter.pyx:Splitter.init draws the splitter's seed from a RandomState of the tree's seed
        splitter_seeds = np.array([np.random.RandomState(s).randint(0, RAND_R_MAX) for s in part], dtype=np.uint32)
        handle = lib.tem_forest_fit(
            _pointer(columns, ctypes.c_float), _pointer(y32, ctypes.c_int32), n_samples, n_features, len(classes),
            len(part), None if counts is None else _pointer(counts, ctypes.c_int32),
            _pointer(splitter_seeds, ctypes.c_uint32), criterion, _max_features(kw["max_features"], n_features),
            max_depth, min_samples_split, min_samples_leaf, float(min_weight_leaf),
            float(kw["min_impurity_decrease"]), threads)
        if not handle:
            raise MemoryError(f"fit_forest ran out of memory growing {len(part)} trees on {n_samples} samples")
        try:
            trees.append(_copy_trees(lib, handle, len(part), len(classes)))
        finally:
            lib.tem_forest_free(handle)
    arrays = {k: np.concatenate([t[k] for t in trees]) for k in trees[0]}
    sizes = arrays.pop("sizes")
    forest = Forest(np.concatenate([[0], np.cumsum(sizes)]), arrays["feature"], arrays["threshold"],
                    arrays["children_left"], arrays["children_right"], arrays["value"], classes, n_features,
                    impurity=arrays["impurity"], n_node_samples=arrays["n_node_samples"],
                    weighted_n_node_samples=arrays["weighted_n_node_samples"])
    forest.params = {k: v for k, v in kw.items() if not isinstance(v, np.random.RandomState)}
    forest.tree_seeds = seeds
    return forest


def _pointer(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _copy_trees(lib, handle, n_trees: int, n_classes: int) -> dict:
    sizes = np.empty(n_trees, dtype=np.int64)
    lib.tem_forest_sizes(handle, _pointer(sizes, ctypes.c_int64))
    n = int(sizes.sum())
    out = {"feature": np.empty(n, np.int64), "threshold": np.empty(n, np.float64),
           "children_left": np.empty(n, np.int64), "children_right": np.empty(n, np.int64),
           "value": np.empty((n, n_classes), np.float64), "impurity": np.empty(n, np.float64),
           "n_node_samples": np.empty(n, np.int64), "weighted_n_node_samples": np.empty(n, np.float64)}
    lib.tem_forest_copy(handle, n_classes, *(_pointer(arr, ctypes.c_double if arr.dtype == np.float64 else
                                                      ctypes.c_int64) for arr in out.values()))
    out["sizes"] = sizes
    return out


def node_differences(a: Forest, b: Forest) -> List[str]:
    """The names of the arrays in which two forests differ: the node offsets, ``feature``,
    ``threshold`` (bitwise), the children, ``value``, ``classes_`` and, where both carry them,
    ``impurity``, ``n_node_samples`` and ``weighted_n_node_samples``. Empty when the trees are
    equal node for node."""
    names = ["node_offsets", "feature", "children_left", "children_right", "value", "classes_"]
    names += [k for k in NODE_STATISTICS if getattr(a, k) is not None and getattr(b, k) is not None]
    differ = [k for k in names if not np.array_equal(getattr(a, k), getattr(b, k))]
    if a.threshold.shape != b.threshold.shape or \
            not np.array_equal(a.threshold.view(np.int64), b.threshold.view(np.int64)):
        differ.insert(1, "threshold")
    if a.n_features_in_ != b.n_features_in_:
        differ.append("n_features_in_")
    return differ


def _tree_depth(left, right) -> int:
    """The depth of a tree (a root alone has depth 0) from its children; a parent precedes its
    children in sklearn's node order."""
    depth = np.zeros(len(left), np.int64)
    for node in range(len(left)):
        if left[node] >= 0:
            depth[left[node]] = depth[right[node]] = depth[node] + 1
    return int(depth.max())


def forest_to_sklearn(forest: Forest):
    """A fitted sklearn ``RandomForestClassifier`` with ``forest``'s trees, built through
    ``Tree.__setstate__``: it predicts as ``forest`` does and pickles as the JAX package's forests.
    It takes the arguments ``forest`` was fitted with (sklearn's defaults where unknown) and
    carries ``feature_ndim``, ``feature_config`` and, where ``forest`` has them,
    ``train_features`` and ``train_labels``. Needs sklearn and the node statistics."""
    try:
        from sklearn.ensemble import RandomForestClassifier
        from sklearn.tree import DecisionTreeClassifier
        from sklearn.tree._tree import NODE_DTYPE, Tree
    except ImportError as e:
        raise _sklearn_missing("building a sklearn forest") from e
    if any(getattr(forest, k) is None for k in NODE_STATISTICS):
        raise ValueError("forest_to_sklearn needs the forest's impurity and sample counts")
    params = {k: v for k, v in (forest.params or {}).items() if k != "random_state"}
    rf = RandomForestClassifier(**params)
    tree_params = {k: getattr(rf, k) for k in rf.estimator_params if k != "random_state"}
    n_classes, n_features = forest.n_classes_, forest.n_features_in_
    max_features = _max_features(rf.max_features, n_features)
    estimators = []
    for t in range(forest.n_estimators):
        lo, hi = forest.node_offsets[t], forest.node_offsets[t + 1]
        left, right = forest.children_left[lo:hi], forest.children_right[lo:hi]
        nodes = np.zeros(hi - lo, dtype=NODE_DTYPE)
        nodes["left_child"], nodes["right_child"] = left, right
        nodes["feature"], nodes["threshold"] = forest.feature[lo:hi], forest.threshold[lo:hi]
        nodes["impurity"] = forest.impurity[lo:hi]
        nodes["n_node_samples"] = forest.n_node_samples[lo:hi]
        nodes["weighted_n_node_samples"] = forest.weighted_n_node_samples[lo:hi]
        # a split sends missing values to its larger child (_splitter.pyx: n_left > n_right)
        split = left >= 0
        counts = forest.n_node_samples[lo:hi]
        nodes["missing_go_to_left"][split] = counts[left[split]] > counts[right[split]]
        tree = Tree(n_features, np.array([n_classes], dtype=np.intp), 1)
        tree.__setstate__({"max_depth": _tree_depth(left, right), "node_count": hi - lo, "nodes": nodes,
                           "values": np.ascontiguousarray(forest.value[lo:hi, None, :])})
        seed = None if forest.tree_seeds is None else forest.tree_seeds[t]
        estimator = DecisionTreeClassifier(**tree_params, random_state=seed)
        estimator.n_features_in_, estimator.n_outputs_, estimator.max_features_ = n_features, 1, max_features
        estimator.classes_, estimator.n_classes_ = np.arange(n_classes, dtype=np.float64), n_classes
        estimator.tree_ = tree
        estimators.append(estimator)
    rf.random_state = (forest.params or {}).get("random_state")
    rf.estimator_ = DecisionTreeClassifier()
    rf.estimators_ = estimators
    rf.n_features_in_, rf.n_outputs_ = n_features, 1
    rf.classes_, rf.n_classes_ = forest.classes_, n_classes
    for name in ("feature_ndim", "feature_config", "train_features", "train_labels"):
        if getattr(forest, name, None) is not None:
            setattr(rf, name, getattr(forest, name))
    return rf


def save_forest(forest: Forest, path) -> None:
    """Write a ``Forest`` to an ``.npz`` file, its node statistics where it has them."""
    config = None if forest.feature_config is None else [
        [name, list(sigma) if isinstance(sigma, tuple) else sigma] for name, sigma in forest.feature_config]
    statistics = {k: getattr(forest, k) for k in NODE_STATISTICS if getattr(forest, k) is not None}
    np.savez_compressed(
        path, node_offsets=forest.node_offsets, feature=forest.feature.astype(np.int32),
        threshold=forest.threshold, children_left=forest.children_left.astype(np.int32),
        children_right=forest.children_right.astype(np.int32), value=forest.value, classes=forest.classes_,
        n_features_in=np.int64(forest.n_features_in_),
        feature_ndim=np.int64(-1 if forest.feature_ndim is None else forest.feature_ndim),
        feature_config=np.str_(json.dumps(config)), **statistics,
    )


def load_forest(path) -> Forest:
    """A forest from an ``.npz`` file (numpy only) or a pickled sklearn forest (``.pkl``)."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as f:
            ndim = int(f["feature_ndim"])
            return Forest(f["node_offsets"], f["feature"], f["threshold"], f["children_left"],
                          f["children_right"], f["value"], f["classes"], int(f["n_features_in"]),
                          None if ndim < 0 else ndim, json.loads(str(f["feature_config"])),
                          *(f[k] if k in f.files else None for k in NODE_STATISTICS))
    try:
        import sklearn  # noqa: F401  (unpickling the forest imports it)
    except ImportError as e:
        raise _sklearn_missing(f"loading the pickled forest {os.path.basename(path)}") from e
    with open(path, "rb") as f:
        return forest_from_sklearn(pickle.load(f))


def forest_paths(folder, extensions: Sequence[str] = (".npz", ".pkl")) -> List[str]:
    """The sorted forest files of a folder: its ``.npz`` files where it has any, else its ``.pkl``."""
    names = sorted(os.listdir(folder))
    for ext in extensions:
        found = [os.path.join(folder, n) for n in names if n.endswith(ext)]
        if found:
            return found
    return []
