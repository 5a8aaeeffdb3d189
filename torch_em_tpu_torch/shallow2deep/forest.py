"""A random forest as plain arrays: fitted natively, evaluated in numpy.

The JAX package, like torch-em, fits its Shallow2Deep forests with scikit-learn's
``RandomForestClassifier``, keeps them pickled and predicts with sklearn. The
machine with the card has no sklearn, so the port fits, keeps and evaluates a
forest itself:

- ``Forest`` holds every tree's ``feature``, ``threshold``,
  ``children_left``, ``children_right`` (-1 at a leaf), class ``value`` (the
  fraction of each class in the node) and, where known, ``impurity``,
  ``n_node_samples``, ``weighted_n_node_samples`` and ``missing_go_to_left``,
  concatenated in estimator order with ``node_offsets``, and the forest's
  ``classes_``, ``n_features_in_``, the Shallow2Deep metadata ``feature_ndim``
  and ``feature_config`` and, where it has them, ``train_features``,
  ``train_labels``, ``oob_score_`` and ``oob_decision_function_``;
- ``fit_forest(features, labels, **rf_kwargs)`` fits one with every argument
  of ``RandomForestClassifier`` and its defaults and gives sklearn 1.9's trees
  node for node: the random draws are numpy's, as sklearn makes them (one seed
  per tree from ``random_state``, the bootstrap by the legacy
  ``RandomState.randint``, or ``RandomState.choice`` weighted by the class
  weights), the trees are grown by ``ops/native/forest.cpp`` on ``n_jobs``
  threads;
- ``forest_from_sklearn(rf)`` reads the arrays of a fitted sklearn forest, or of
  the stand-ins that ``sklearn_pickle`` unpickles, ``forest_to_sklearn(forest)``
  builds a sklearn forest from them (where sklearn is installed), which
  predicts as the one that was fitted;
- ``save_forest(forest, path)`` writes an ``.npz`` file and
  ``save_forest_pickle(forest, path)`` the pickle of sklearn's forest of the
  same trees (``rf_XXXX.pkl``, as the JAX package writes it), both without
  sklearn; ``load_forest(path)`` reads either, a pickle through
  ``sklearn_pickle``'s restricted unpickler, never through sklearn.

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
import sys
import warnings
from typing import List, Optional, Sequence

import numpy as np

from . import sklearn_pickle

__all__ = ["Forest", "fit_forest", "forest_from_sklearn", "forest_to_sklearn", "save_forest", "save_forest_pickle",
           "load_forest", "node_differences"]

# the node arrays that a fitted forest may carry beside those that predict
NODE_STATISTICS = ("impurity", "n_node_samples", "weighted_n_node_samples", "missing_go_to_left")
# the attributes that the JAX package's Shallow2Deep forests carry beside sklearn's, and those of an out-of-bag fit
SHALLOW2DEEP_ATTRIBUTES = ("feature_ndim", "feature_config", "train_features", "train_labels")
OOB_ATTRIBUTES = ("oob_decision_function_", "oob_score_")


def _config_from_json(config):
    """The (filter name, sigma) pairs of a feature config, with a list sigma back as a tuple."""
    if config is None:
        return None
    return [(name, tuple(sigma) if isinstance(sigma, list) else sigma) for name, sigma in config]


class Forest:
    """A fitted random forest classifier's trees as arrays, with sklearn's ``predict_proba``."""

    def __init__(self, node_offsets, feature, threshold, children_left, children_right, value, classes,
                 n_features_in: int, feature_ndim: Optional[int] = None, feature_config=None, impurity=None,
                 n_node_samples=None, weighted_n_node_samples=None, missing_go_to_left=None):
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
        self.missing_go_to_left = (None if missing_go_to_left is None
                                   else np.asarray(missing_go_to_left, dtype=np.uint8))
        # fit_forest's arguments and each tree's seed, which forest_to_sklearn gives the sklearn forest
        self.params, self.tree_seeds = None, None
        self.train_features = self.train_labels = self.oob_score_ = self.oob_decision_function_ = None
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


def _value_is_fraction(version: Optional[str]) -> bool:
    """Whether trees of this sklearn version store class fractions (1.4 and later) rather than
    weighted counts; None (a forest that was never pickled) is the running sklearn's."""
    if version is None:
        module = sys.modules.get("sklearn")
        version = getattr(module, "__version__", sklearn_pickle.SKLEARN_VERSION)
    try:
        major, minor = (int(p) for p in str(version).split(".")[:2])
    except ValueError:  # "pre-0.18", a pickle older than sklearn's version stamps
        return False
    return (major, minor) >= (1, 4)


def forest_from_sklearn(rf) -> Forest:
    """The arrays of a fitted sklearn ``RandomForestClassifier`` (one output), or of its
    ``sklearn_pickle`` stand-in, with its arguments and trees' seeds, and its ``feature_ndim``,
    ``feature_config``, ``train_features``, ``train_labels``, ``oob_score_`` and
    ``oob_decision_function_`` where it has them. The nodes are read by field name, so a pickle of
    sklearn before 1.3 (no ``missing_go_to_left``) reads too; whether ``values`` holds counts (sklearn
    before 1.4) or fractions is read from the pickle's ``_sklearn_version``."""
    if getattr(rf, "n_outputs_", 1) != 1:
        raise ValueError("only forests of one output are supported")
    # sklearn's own objects drop the stamp when they unpickle; a stand-in keeps it, or has none before 0.18
    stand_in = isinstance(rf, sklearn_pickle.RandomForestClassifier)
    fraction = _value_is_fraction(rf.__dict__.get("_sklearn_version", "pre-0.18" if stand_in else None))
    n_classes = len(rf.classes_)
    parts = {k: [] for k in ("feature", "threshold", "left_child", "right_child", "impurity", "n_node_samples",
                             "weighted_n_node_samples", "missing_go_to_left", "value")}
    offsets = [0]
    for estimator in rf.estimators_:
        state = estimator.tree_.__getstate__()
        count = int(state["node_count"])
        nodes = state["nodes"][:count]
        value = np.asarray(state["values"][:count, 0, :n_classes], dtype=np.float64)
        if not fraction:  # counts: normalised as sklearn's predict_proba did before 1.4
            normalizer = value.sum(axis=1)[:, None]
            normalizer[normalizer == 0.0] = 1.0
            value = value / normalizer
        for name in parts:
            if name == "value":
                parts[name].append(value)
            elif name in nodes.dtype.names:
                parts[name].append(nodes[name])
        offsets.append(offsets[-1] + count)
    arrays = {k: np.concatenate(v) for k, v in parts.items() if len(v) == len(rf.estimators_)}
    forest = Forest(offsets, arrays["feature"], arrays["threshold"], arrays["left_child"], arrays["right_child"],
                    arrays["value"], rf.classes_, rf.n_features_in_, getattr(rf, "feature_ndim", None),
                    getattr(rf, "feature_config", None), *(arrays.get(k) for k in NODE_STATISTICS))
    for name in SHALLOW2DEEP_ATTRIBUTES[2:] + OOB_ATTRIBUTES:
        setattr(forest, name, getattr(rf, name, None))
    forest.params = {k: rf.__dict__[k] for k in FIT_DEFAULTS if k in rf.__dict__ and
                     not isinstance(rf.__dict__[k], np.random.RandomState)} or None
    seeds = [getattr(e, "random_state", None) for e in rf.estimators_]
    forest.tree_seeds = seeds if all(isinstance(s, numbers.Integral) for s in seeds) else None
    return forest


# RandomForestClassifier's arguments and defaults in sklearn 1.9
FIT_DEFAULTS = dict(
    n_estimators=100, criterion="gini", max_depth=None, min_samples_split=2, min_samples_leaf=1,
    min_weight_fraction_leaf=0.0, max_features="sqrt", max_leaf_nodes=None, min_impurity_decrease=0.0,
    bootstrap=True, oob_score=False, n_jobs=None, random_state=None, verbose=0, warm_start=False,
    class_weight=None, ccp_alpha=0.0, max_samples=None, monotonic_cst=None,
)
MAX_INT = np.iinfo(np.int32).max
RAND_R_MAX = 2147483647  # sklearn/utils/_random.pxd
# the sample weights of at most this many bytes are drawn at once (more trees go in several calls)
WEIGHT_BYTES = 256 << 20
CLASS_WEIGHT_PRESETS = ("balanced", "balanced_subsample")


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


def _n_samples_bootstrap(n_samples, max_samples, sample_weight=None) -> int:
    """ensemble/_bootstrap.py:_get_n_samples_bootstrap: a fractional ``max_samples`` is a share of
    the samples, or of the sum of the sample weights where there are any."""
    if max_samples is None:
        return n_samples
    if isinstance(max_samples, numbers.Integral):
        if max_samples < 1:
            raise ValueError(f"max_samples must be at least 1, got {max_samples}")
        return int(max_samples)
    if not max_samples > 0.0:
        raise ValueError(f"max_samples must be above 0, got {max_samples}")
    if sample_weight is None:
        weighted, message = n_samples, f"the number of samples is {n_samples} "
    else:
        weighted = sample_weight.sum()
        message = f"the total sum of sample weights is {weighted} "
    n = max(int(max_samples * weighted), 1)
    if n < max(10, n_samples ** (1 / 3)):
        warnings.warn(f"Using the fractional value max_samples={max_samples} when {message}results in a low number "
                      f"({n}) of bootstrap samples. We recommend passing `max_samples` as an integer instead.")
    return n


def _invalid(name, expected, value) -> ValueError:
    """sklearn's InvalidParameterError message for an argument outside its constraints."""
    return ValueError(f"The '{name}' parameter of RandomForestClassifier must be {expected}. Got {value!r} instead.")


def _check_new_arguments(kw):
    """The constraints sklearn's ``_parameter_constraints`` put on the arguments of the best-first,
    weighted, pruned, out-of-bag and constrained fits, with its messages."""
    bools = (bool, np.bool_)
    value = kw["max_leaf_nodes"]
    if value is not None and (not isinstance(value, numbers.Integral) or isinstance(value, bool) or value < 2):
        raise _invalid("max_leaf_nodes", "an int in the range [2, inf) or None", value)
    value = kw["ccp_alpha"]
    if not isinstance(value, numbers.Real) or isinstance(value, bool) or not value >= 0.0:
        raise _invalid("ccp_alpha", "a float in the range [0.0, inf)", value)
    value = kw["class_weight"]
    if not (value is None or isinstance(value, (dict, list)) or (isinstance(value, str) and
                                                                 value in CLASS_WEIGHT_PRESETS)):
        # sklearn lists StrOptions({"balanced_subsample", "balanced"}) in the set's order, which string hashing sets
        options = ", ".join(repr(o) for o in {"balanced_subsample", "balanced"})
        raise _invalid("class_weight", f"a str among {{{options}}}, an instance of 'dict', an instance of 'list' "
                       "or None", value)
    if not (isinstance(kw["oob_score"], bools) or callable(kw["oob_score"])):
        raise _invalid("oob_score", "an instance of 'bool' or an instance of 'numpy.bool' or a callable",
                       kw["oob_score"])
    if not isinstance(kw["warm_start"], bools):
        raise _invalid("warm_start", "an instance of 'bool' or an instance of 'numpy.bool'", kw["warm_start"])
    value = kw["monotonic_cst"]
    array_like = hasattr(value, "__len__") or hasattr(value, "shape") or hasattr(value, "__array__")
    if value is not None and (not array_like or np.isscalar(value)):
        raise _invalid("monotonic_cst", "an array-like or None", value)


def _class_weight_vector(class_weight, classes) -> np.ndarray:
    """utils/class_weight.py:compute_class_weight for a dict (or a list, which names no class):
    each class's weight, 1 where it is not named."""
    weight = np.ones(len(classes), dtype=np.float64)
    if len(class_weight) == 0:
        return weight
    unweighted = []
    for i, c in enumerate(classes):
        try:
            c = int(c)
        except ValueError:  # string classes
            c = str(c)
        if c in class_weight:
            weight[i] = class_weight[c]
        else:
            unweighted.append(c)
    if unweighted and len(classes) - len(unweighted) != len(class_weight):
        raise ValueError(f"The classes, {np.array(unweighted).tolist()}, are not in class_weight")
    return weight


def _balanced_weights(encoded) -> np.ndarray:
    """compute_class_weight("balanced") of encoded labels, for their classes in sorted order:
    n_samples / (n_classes * the count of each class), the counts summed as float64 weights."""
    present, index = np.unique(encoded, return_inverse=True)
    counts = np.bincount(index, weights=np.ones(len(encoded), dtype=np.float64))
    return np.sum(counts) / (len(present) * counts)


def _expanded_class_weight(class_weight, bootstrap, labels, classes, encoded):
    """ensemble/_forest.py:_validate_y_class_weight: each sample's class weight for a dict or
    "balanced" (or "balanced_subsample" without the bootstrap), None otherwise."""
    if class_weight is None or (class_weight == "balanced_subsample" and bootstrap):
        return None
    if isinstance(class_weight, (dict, list)):
        return _class_weight_vector(class_weight, classes)[encoded]
    return _balanced_weights(encoded)[encoded]


def _subsample_weights(encoded, indices, n_classes) -> np.ndarray:
    """compute_sample_weight("balanced", y, indices=indices) for "balanced_subsample": each
    sample's class weight in the bootstrap, 0 for a class the bootstrap missed."""
    subsample = encoded[indices]
    present = np.unique(subsample)
    weight = np.take(_balanced_weights(subsample), np.searchsorted(present, np.arange(n_classes)), mode="clip")
    expanded = weight[encoded]
    missing = np.setdiff1d(np.arange(n_classes), present)
    if missing.size:
        expanded[np.isin(encoded, missing)] = 0.0
    return expanded


def _monotonic_signs(monotonic_cst, n_features, n_classes) -> Optional[np.ndarray]:
    """tree/_classes.py: the checked constraints, their signs flipped to constrain the negative class."""
    if monotonic_cst is None:
        return None
    cst = np.asarray(monotonic_cst)
    if cst.shape[0] != n_features:
        raise ValueError(f"monotonic_cst has shape {cst.shape[0]} but the input data X has {n_features} features.")
    if not np.all(np.isin(cst, (-1, 0, 1))):
        raise ValueError(f"monotonic_cst must be None or an array-like of -1, 0 or 1, but got {np.unique(cst)}")
    if n_classes > 2:
        raise ValueError("Monotonicity constraints are not supported with multiclass classification")
    return np.ascontiguousarray(-np.asarray(cst, dtype=np.int8))


def fit_forest(features, labels, **rf_kwargs) -> Forest:
    """A random forest classifier fitted on ``features`` (n_samples, n_features) and ``labels``
    (n_samples,), equal node for node to sklearn 1.9's
    ``RandomForestClassifier(**rf_kwargs).fit(features, labels)``: the same trees in the same
    order, with the same features, thresholds, children, class fractions, impurities and sample
    counts. ``rf_kwargs`` are all of sklearn's arguments with sklearn's defaults:

    - ``random_state`` None draws from the global ``np.random`` as sklearn does;
    - ``n_jobs`` threads grow the trees, which do not depend on their number; ``verbose`` is
      ignored;
    - ``class_weight`` ("balanced", "balanced_subsample", a dict) weights the bootstrap's draw or,
      without the bootstrap, the trees; ``max_leaf_nodes`` grows the trees best first,
      ``ccp_alpha`` prunes them, ``monotonic_cst`` (two classes) constrains them;
    - ``oob_score`` (True or a function of the labels and the predicted classes) sets
      ``oob_score_`` and ``oob_decision_function_`` on the forest;
    - ``warm_start`` is recorded: every call starts from no trees, as every
      ``RandomForestClassifier(**rf_kwargs)`` that the JAX package builds does, so it grows the forest
      it would grow without it.

    The features are cast to float32, as sklearn casts them, and must be dense and finite; there
    are no sample weights."""
    from ..ops.native import load_forest_library

    unknown = sorted(set(rf_kwargs) - set(FIT_DEFAULTS))
    if unknown:
        raise TypeError(f"fit_forest got arguments that RandomForestClassifier does not take: {unknown}")
    kw = {**FIT_DEFAULTS, **rf_kwargs}
    _check_new_arguments(kw)
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
    encoded = encoded.reshape(-1)
    n_samples, n_features = x.shape
    bootstrap, class_weight = kw["bootstrap"], kw["class_weight"]

    # ensemble/_forest.py:fit, in its order of checks and draws
    if isinstance(class_weight, str) and kw["warm_start"]:
        warnings.warn('class_weight presets "balanced" or "balanced_subsample" are not recommended for warm_start '
                      'if the fitted data differs from the full dataset. In order to use "balanced" weights, use '
                      'compute_class_weight ("balanced", classes, y). In place of y you can use a large enough sample '
                      'of the full training set target to properly estimate the class frequency distributions. Pass '
                      'the resulting weights as the class_weight parameter.')
    sample_weight = _expanded_class_weight(class_weight, bootstrap, y, classes, encoded)
    if not bootstrap and kw["max_samples"] is not None:
        raise ValueError("`max_sample` cannot be set if `bootstrap=False`. Either switch to `bootstrap=True` or set "
                         "`max_sample=None`.")
    n_bootstrap = _n_samples_bootstrap(n_samples, kw["max_samples"], sample_weight) if bootstrap else None
    if not bootstrap and kw["oob_score"]:
        raise ValueError("Out of bag estimation only available if bootstrap=True")
    random_state = _check_random_state(kw["random_state"])
    # ensemble/_base.py:_set_random_states, one draw per tree in estimator order
    seeds = [random_state.randint(MAX_INT) for _ in range(n_estimators)]
    monotonic = _monotonic_signs(kw["monotonic_cst"], n_features, len(classes))

    min_samples_leaf = _min_samples(kw["min_samples_leaf"], "min_samples_leaf", n_samples, 1)
    min_samples_split = max(2, _min_samples(kw["min_samples_split"], "min_samples_split", n_samples, 2))
    min_samples_split = max(min_samples_split, 2 * min_samples_leaf)
    threads = _n_jobs(kw["n_jobs"])
    max_depth = MAX_INT if kw["max_depth"] is None else int(kw["max_depth"])
    max_leaf_nodes = -1 if kw["max_leaf_nodes"] is None else int(kw["max_leaf_nodes"])
    draw_probability = None if sample_weight is None else sample_weight / np.sum(sample_weight)

    lib = load_forest_library()
    columns = np.ascontiguousarray(x.T)
    y32 = np.ascontiguousarray(encoded, dtype=np.int32)
    chunk = max(threads, WEIGHT_BYTES // (8 * n_samples)) if bootstrap else n_estimators
    trees, unsampled = [], []
    for first in range(0, n_estimators, chunk):
        part = seeds[first:first + chunk]
        if bootstrap:
            # _forest.py:_generate_sample_indices and _parallel_build_trees: the counts of the draw are the
            # trees' sample weights, times the bootstrap's class weights for "balanced_subsample"
            weights = np.empty((len(part), n_samples), dtype=np.float64)
            for row, s in enumerate(part):
                draws = np.random.RandomState(s)
                indices = (draws.randint(0, n_samples, n_bootstrap) if draw_probability is None else
                           draws.choice(n_samples, n_bootstrap, replace=True, p=draw_probability)).astype(np.int32)
                counts = np.bincount(indices, minlength=n_samples)
                unsampled.append(np.flatnonzero(counts == 0))
                weights[row] = (counts * _subsample_weights(encoded, indices, len(classes))
                                if class_weight == "balanced_subsample" else counts)
            stride = n_samples
        else:
            weights = None if sample_weight is None else np.ascontiguousarray(sample_weight, dtype=np.float64)
            stride = 0
        # tree/_classes.py: min_weight_leaf from the sum of the tree's sample weights
        if weights is None:
            min_weight_leaf = np.full(len(part), kw["min_weight_fraction_leaf"] * n_samples, dtype=np.float64)
        else:
            rows = weights if bootstrap else [weights] * len(part)
            min_weight_leaf = np.array([kw["min_weight_fraction_leaf"] * np.sum(w) for w in rows], dtype=np.float64)
        # _splitter.pyx:Splitter.init draws the splitter's seed from a RandomState of the tree's seed
        splitter_seeds = np.array([np.random.RandomState(s).randint(0, RAND_R_MAX) for s in part], dtype=np.uint32)
        handle = lib.tem_forest_fit(
            _pointer(columns, ctypes.c_float), _pointer(y32, ctypes.c_int32), n_samples, n_features, len(classes),
            len(part), None if weights is None else _pointer(weights, ctypes.c_double), stride,
            _pointer(min_weight_leaf, ctypes.c_double),
            _pointer(splitter_seeds, ctypes.c_uint32), criterion, _max_features(kw["max_features"], n_features),
            max_depth, min_samples_split, min_samples_leaf, float(kw["min_impurity_decrease"]), max_leaf_nodes,
            float(kw["ccp_alpha"]), None if monotonic is None else _pointer(monotonic, ctypes.c_int8), threads)
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
                    **{k: arrays[k] for k in NODE_STATISTICS})
    forest.params = {k: v for k, v in kw.items() if not isinstance(v, np.random.RandomState)}
    forest.tree_seeds = seeds
    if kw["oob_score"]:
        _set_oob_score(forest, x, encoded, unsampled, kw["oob_score"])
    return forest


def _set_oob_score(forest: Forest, x, encoded, unsampled, scoring):
    """ensemble/_forest.py:_compute_oob_predictions and _set_oob_score_and_attributes: each sample's
    class fractions summed over the trees that did not draw it, in estimator order, over their
    number; the score the accuracy of their argmax (or ``scoring`` of the labels and it)."""
    leaves = forest.apply(x)
    n_samples = len(encoded)
    oob_pred = np.zeros((n_samples, forest.n_classes_), dtype=np.float64)
    n_oob_pred = np.zeros((n_samples, 1), dtype=np.int64)
    for tree_leaves, indices in zip(leaves, unsampled):
        oob_pred[indices] += forest.value[tree_leaves[indices]]
        n_oob_pred[indices] += 1
    if (n_oob_pred == 0).any():
        warnings.warn("Some inputs do not have OOB scores. This probably means too few trees were used to compute "
                      "any reliable OOB estimates.", UserWarning)
        n_oob_pred[n_oob_pred == 0] = 1
    oob_pred /= n_oob_pred
    forest.oob_decision_function_ = oob_pred
    y = encoded.astype(np.float64).reshape(-1, 1)
    predicted = np.argmax(oob_pred, axis=1)
    forest.oob_score_ = float(np.mean(y[:, 0] == predicted)) if scoring is True or scoring is np.True_ \
        else scoring(y, predicted)


def _pointer(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _copy_trees(lib, handle, n_trees: int, n_classes: int) -> dict:
    sizes = np.empty(n_trees, dtype=np.int64)
    lib.tem_forest_sizes(handle, _pointer(sizes, ctypes.c_int64))
    n = int(sizes.sum())
    out = {"feature": np.empty(n, np.int64), "threshold": np.empty(n, np.float64),
           "children_left": np.empty(n, np.int64), "children_right": np.empty(n, np.int64),
           "value": np.empty((n, n_classes), np.float64), "impurity": np.empty(n, np.float64),
           "n_node_samples": np.empty(n, np.int64), "weighted_n_node_samples": np.empty(n, np.float64),
           "missing_go_to_left": np.empty(n, np.uint8)}
    ctypes_of = {np.dtype(np.float64): ctypes.c_double, np.dtype(np.int64): ctypes.c_int64,
                 np.dtype(np.uint8): ctypes.c_uint8}
    lib.tem_forest_copy(handle, n_classes, *(_pointer(arr, ctypes_of[arr.dtype]) for arr in out.values()))
    out["sizes"] = sizes
    return out


def node_differences(a: Forest, b: Forest) -> List[str]:
    """The names of the arrays in which two forests differ: the node offsets, ``feature``,
    ``threshold`` (bitwise), the children, ``value``, ``classes_`` and, where both carry them,
    ``impurity``, ``n_node_samples``, ``weighted_n_node_samples`` and ``missing_go_to_left``.
    Empty when the trees are equal node for node."""
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


# sklearn 1.9's NODE_DTYPE (sklearn/tree/_tree.pyx), in field order
NODE_DTYPE = np.dtype({
    "names": ["left_child", "right_child", "feature", "threshold", "impurity", "n_node_samples",
              "weighted_n_node_samples", "missing_go_to_left"],
    "formats": [np.intp, np.intp, np.intp, np.float64, np.float64, np.intp, np.float64, np.uint8],
    "offsets": [0, 8, 16, 24, 32, 40, 48, 56], "itemsize": 64})
# RandomForestClassifier.estimator_params and DecisionTreeClassifier's arguments, in sklearn 1.9's order
ESTIMATOR_PARAMS = ("criterion", "max_depth", "min_samples_split", "min_samples_leaf", "min_weight_fraction_leaf",
                    "max_features", "max_leaf_nodes", "min_impurity_decrease", "random_state", "ccp_alpha",
                    "monotonic_cst")
TREE_DEFAULTS = dict(criterion="gini", splitter="best", max_depth=None, min_samples_split=2, min_samples_leaf=1,
                     min_weight_fraction_leaf=0.0, max_features=None, max_leaf_nodes=None, random_state=None,
                     min_impurity_decrease=0.0, class_weight=None, ccp_alpha=0.0, monotonic_cst=None)
FOREST_PARAMS = ("bootstrap", "oob_score", "n_jobs", "random_state", "verbose", "warm_start", "class_weight",
                 "max_samples", "criterion", "max_depth", "min_samples_split", "min_samples_leaf",
                 "min_weight_fraction_leaf", "max_features", "max_leaf_nodes", "min_impurity_decrease",
                 "monotonic_cst", "ccp_alpha")


def _sklearn_objects(forest: Forest, forest_cls, tree_cls, tree_struct_cls, version=None):
    """sklearn's fitted ``RandomForestClassifier`` of ``forest``'s trees, built from ``forest_cls``,
    ``tree_cls`` and ``tree_struct_cls`` (sklearn's classes, or ``sklearn_pickle``'s stand-ins) with the
    attributes sklearn's fit sets, in its order, but for the private ``_n_samples``,
    ``_sample_weight`` and ``_n_samples_bootstrap``. ``version``, where given, is stamped as each
    estimator's ``_sklearn_version``, as sklearn's ``__getstate__`` stamps it."""
    if any(getattr(forest, k) is None for k in NODE_STATISTICS[:3]):
        raise ValueError("a sklearn forest needs the forest's impurity and sample counts")
    params = {**FIT_DEFAULTS, **(forest.params or {})}
    n_classes, n_features = forest.n_classes_, forest.n_features_in_
    stamp = {} if version is None else {"_sklearn_version": version}

    def new(cls, state):
        obj = cls.__new__(cls)
        obj.__dict__.update(state, **stamp)
        return obj

    default_tree = new(tree_cls, TREE_DEFAULTS)
    max_features = _max_features(params["max_features"], n_features)
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
        if forest.missing_go_to_left is not None:
            nodes["missing_go_to_left"] = forest.missing_go_to_left[lo:hi]
        else:  # a split sends missing values to its larger child (_splitter.pyx: n_left > n_right)
            split = left >= 0
            counts = forest.n_node_samples[lo:hi]
            nodes["missing_go_to_left"][split] = counts[left[split]] > counts[right[split]]
        tree = tree_struct_cls(n_features, np.array([n_classes], dtype=np.intp), 1)
        tree.__setstate__({"max_depth": _tree_depth(left, right), "node_count": int(hi - lo), "nodes": nodes,
                           "values": np.ascontiguousarray(forest.value[lo:hi, None, :])})
        state = {**TREE_DEFAULTS, **{k: params[k] for k in ESTIMATOR_PARAMS},
                 "random_state": None if forest.tree_seeds is None else forest.tree_seeds[t]}
        state.update(n_features_in_=n_features, n_outputs_=1, classes_=np.arange(n_classes, dtype=np.float64),
                     n_classes_=np.intp(n_classes), max_features_=max_features, tree_=tree)
        estimators.append(new(tree_cls, state))
    state = {"estimator": default_tree, "n_estimators": params["n_estimators"], "estimator_params": ESTIMATOR_PARAMS,
             **{k: params[k] for k in FOREST_PARAMS}, "n_features_in_": n_features, "n_outputs_": 1,
             "classes_": forest.classes_, "n_classes_": n_classes, "estimator_": default_tree, "estimators_": estimators}
    for name in OOB_ATTRIBUTES + SHALLOW2DEEP_ATTRIBUTES:
        if getattr(forest, name) is not None:
            state[name] = getattr(forest, name)
    return new(forest_cls, state)


def forest_to_sklearn(forest: Forest):
    """A fitted sklearn ``RandomForestClassifier`` with ``forest``'s trees, built through
    ``Tree.__setstate__``: it predicts as ``forest`` does and pickles as the JAX package's forests.
    It takes the arguments ``forest`` was fitted with (sklearn's defaults where unknown) and
    carries ``feature_ndim``, ``feature_config`` and, where ``forest`` has them,
    ``train_features``, ``train_labels``, ``oob_score_`` and ``oob_decision_function_``. Needs
    sklearn and the node statistics."""
    try:
        from sklearn.ensemble import RandomForestClassifier
        from sklearn.tree import DecisionTreeClassifier
        from sklearn.tree._tree import Tree
    except ImportError as e:
        raise ImportError("building a sklearn forest needs scikit-learn (sklearn), which is not installed; "
                          "save_forest_pickle writes the pickle of the same forest without it") from e
    return _sklearn_objects(forest, RandomForestClassifier, DecisionTreeClassifier, Tree)


def save_forest_pickle(forest: Forest, path) -> None:
    """Write ``forest`` as the pickle of sklearn's ``RandomForestClassifier`` of the same trees
    (``forest_to_sklearn``'s state, stamped with sklearn 1.9), without sklearn: a plain
    ``pickle.load`` with sklearn 1.9 installed gives the fitted forest, as the JAX package's
    ``rf_XXXX.pkl``. The bytes depend only on the forest."""
    data = sklearn_pickle.dumps(_sklearn_objects(forest, sklearn_pickle.RandomForestClassifier,
                                                 sklearn_pickle.DecisionTreeClassifier, sklearn_pickle.Tree,
                                                 version=sklearn_pickle.SKLEARN_VERSION))
    with open(path, "wb") as f:
        f.write(data)


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
    """A forest from an ``.npz`` file or a pickled sklearn forest (``.pkl``), both read with numpy
    alone: a pickle through ``sklearn_pickle.load``, which refuses any global a forest does not hold."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as f:
            ndim = int(f["feature_ndim"])
            return Forest(f["node_offsets"], f["feature"], f["threshold"], f["children_left"],
                          f["children_right"], f["value"], f["classes"], int(f["n_features_in"]),
                          None if ndim < 0 else ndim, json.loads(str(f["feature_config"])),
                          *(f[k] if k in f.files else None for k in NODE_STATISTICS))
    with open(path, "rb") as f:
        return forest_from_sklearn(sklearn_pickle.load(f))


def forest_paths(folder, extensions: Sequence[str] = (".npz", ".pkl")) -> List[str]:
    """The sorted forest files of a folder: its ``.npz`` files where it has any, else its ``.pkl``."""
    names = sorted(os.listdir(folder))
    for ext in extensions:
        found = [os.path.join(folder, n) for n in names if n.endswith(ext)]
        if found:
            return found
    return []
