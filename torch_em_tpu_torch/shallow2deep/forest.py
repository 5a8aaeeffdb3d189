"""A fitted random forest as plain arrays, evaluated in numpy.

The JAX package, like torch-em, keeps its Shallow2Deep forests as pickled
scikit-learn ``RandomForestClassifier`` objects and predicts with sklearn.
The machine with the card has no sklearn, so the port also keeps a forest as
arrays and computes ``predict_proba`` itself:

- ``Forest`` holds every tree's ``feature``, ``threshold``,
  ``children_left``, ``children_right`` (-1 at a leaf) and class ``value``
  (the fraction of each class in the node), concatenated in estimator order
  with ``node_offsets``, and the forest's ``classes_``, ``n_features_in_``
  and the Shallow2Deep metadata ``feature_ndim`` and ``feature_config``;
- ``forest_from_sklearn(rf)`` reads them from a fitted sklearn forest;
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

import json
import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["Forest", "forest_from_sklearn", "save_forest", "load_forest"]


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
                 n_features_in: int, feature_ndim: Optional[int] = None, feature_config=None):
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
    offsets, parts = [0], {k: [] for k in ("feature", "threshold", "left", "right", "value")}
    for estimator in rf.estimators_:
        tree = estimator.tree_
        value = np.asarray(tree.value[:, 0, :n_classes], dtype=np.float64)
        if not fraction:  # counts: normalised as sklearn's predict_proba did before 1.4
            normalizer = value.sum(axis=1)[:, None]
            normalizer[normalizer == 0.0] = 1.0
            value = value / normalizer
        parts["feature"].append(tree.feature)
        parts["threshold"].append(tree.threshold)
        parts["left"].append(tree.children_left)
        parts["right"].append(tree.children_right)
        parts["value"].append(value)
        offsets.append(offsets[-1] + tree.node_count)
    return Forest(offsets, np.concatenate(parts["feature"]), np.concatenate(parts["threshold"]),
                  np.concatenate(parts["left"]), np.concatenate(parts["right"]),
                  np.concatenate(parts["value"]), rf.classes_, rf.n_features_in_,
                  getattr(rf, "feature_ndim", None), getattr(rf, "feature_config", None))


def save_forest(forest: Forest, path) -> None:
    """Write a ``Forest`` to an ``.npz`` file."""
    config = None if forest.feature_config is None else [
        [name, list(sigma) if isinstance(sigma, tuple) else sigma] for name, sigma in forest.feature_config]
    np.savez_compressed(
        path, node_offsets=forest.node_offsets, feature=forest.feature.astype(np.int32),
        threshold=forest.threshold, children_left=forest.children_left.astype(np.int32),
        children_right=forest.children_right.astype(np.int32), value=forest.value, classes=forest.classes_,
        n_features_in=np.int64(forest.n_features_in_),
        feature_ndim=np.int64(-1 if forest.feature_ndim is None else forest.feature_ndim),
        feature_config=np.str_(json.dumps(config)),
    )


def load_forest(path) -> Forest:
    """A forest from an ``.npz`` file (numpy only) or a pickled sklearn forest (``.pkl``)."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as f:
            ndim = int(f["feature_ndim"])
            return Forest(f["node_offsets"], f["feature"], f["threshold"], f["children_left"],
                          f["children_right"], f["value"], f["classes"], int(f["n_features_in"]),
                          None if ndim < 0 else ndim, json.loads(str(f["feature_config"])))
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
