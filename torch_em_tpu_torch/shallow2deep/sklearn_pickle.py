"""scikit-learn's pickled random forests, read and written without sklearn.

The JAX package, like torch-em, keeps its Shallow2Deep forests as pickles of
sklearn's ``RandomForestClassifier`` (``rf_XXXX.pkl``). The machine with the
card has no sklearn, and a plain ``pickle.load`` of such a file imports it.
This module reads and writes those files with the standard library's pickle
machinery and numpy alone:

- ``load(file)`` unpickles with ``RestrictedUnpickler``, whose ``find_class``
  admits the globals that a pickled forest holds (``ALLOWED``) and nothing
  else: any other global raises ``pickle.UnpicklingError`` naming it, so a
  forest file cannot run code as a bare ``pickle.load`` would. sklearn's three
  classes come back as the plain stand-ins ``RandomForestClassifier``,
  ``DecisionTreeClassifier`` (their attributes as sklearn pickled them,
  ``_sklearn_version`` included) and ``Tree`` (its ``__reduce__`` arguments
  and its state: ``max_depth``, ``node_count``, ``nodes``, ``values``);
- ``dumps(obj)`` pickles a graph of those stand-ins under sklearn's class
  names (protocol 4, as ``pickle.dump`` writes by default), so that a plain
  ``pickle.load`` where sklearn is installed gives sklearn's own objects. The
  standard pickler checks a class by importing its module, which would need
  sklearn: ``Pickler.save_global`` writes the names of ``GLOBAL_NAMES`` itself
  and refuses any other global. numpy arrays, dtypes and scalars are written
  as numpy 2 writes them (``numpy._core.multiarray._reconstruct`` and
  ``scalar``) whatever numpy is installed, so the bytes depend only on the
  objects.

``forest.forest_from_sklearn`` reads the stand-ins as it reads sklearn's
objects, and ``forest.save_forest_pickle`` builds them from a ``Forest``.
"""

import importlib
import io
import pickle
import types
from typing import Any

import numpy as np

__all__ = ["RandomForestClassifier", "DecisionTreeClassifier", "Tree", "RestrictedUnpickler", "Pickler", "load",
           "dumps", "ALLOWED", "SKLEARN_VERSION"]

# the sklearn release whose pickle layout the writer follows (NODE_DTYPE with missing_go_to_left, class
# fractions in ``values``); a pickle stamped with it loads in sklearn 1.9 without an InconsistentVersionWarning
SKLEARN_VERSION = "1.9.0"


class _Estimator:
    """A sklearn estimator's pickled attributes, with no behaviour of its own."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class RandomForestClassifier(_Estimator):
    """Stands for ``sklearn.ensemble._forest.RandomForestClassifier`` in a pickle."""


class DecisionTreeClassifier(_Estimator):
    """Stands for ``sklearn.tree._classes.DecisionTreeClassifier`` in a pickle."""


class Tree:
    """Stands for ``sklearn.tree._tree.Tree``: built from ``(n_features, n_classes, n_outputs)``, its state
    the dict of ``max_depth``, ``node_count``, ``nodes`` (a structured array of ``NODE_DTYPE``) and
    ``values`` (node_count, n_outputs, max_n_classes)."""

    def __init__(self, n_features, n_classes, n_outputs):
        self.n_features, self.n_classes, self.n_outputs = n_features, n_classes, n_outputs
        self.max_depth = self.node_count = self.nodes = self.values = None

    def __getstate__(self):
        return {"max_depth": self.max_depth, "node_count": self.node_count, "nodes": self.nodes,
                "values": self.values}

    def __setstate__(self, state):
        self.max_depth, self.node_count = state["max_depth"], state["node_count"]
        self.nodes, self.values = state["nodes"], state["values"]

    def __reduce__(self):
        return Tree, (self.n_features, self.n_classes, self.n_outputs), self.__getstate__()


def _numpy_function(name: str):
    """numpy's ``multiarray`` or ``numeric`` function ``name`` (``numpy._core`` from numpy 2 on,
    ``numpy.core`` before)."""
    module, attr = name.rsplit(".", 1)
    for package in ("numpy._core", "numpy.core"):
        try:
            return getattr(importlib.import_module(f"{package}.{module}"), attr)
        except (ImportError, AttributeError):
            continue
    raise ImportError(f"numpy has no {name}")


def _allowed():
    """The globals a pickled sklearn forest holds: sklearn's three classes, numpy's array, dtype and scalar
    constructors (numpy 2's and numpy 1's module names, protocol 5's ``_frombuffer``) and a
    ``RandomState`` argument's constructors."""
    from numpy.random import _pickle as random_pickle

    allowed = {
        ("sklearn.ensemble._forest", "RandomForestClassifier"): RandomForestClassifier,
        ("sklearn.tree._classes", "DecisionTreeClassifier"): DecisionTreeClassifier,
        ("sklearn.tree._tree", "Tree"): Tree,
        ("numpy", "dtype"): np.dtype,
        ("numpy", "ndarray"): np.ndarray,
        ("numpy.random._pickle", "__randomstate_ctor"): random_pickle.__randomstate_ctor,
        ("numpy.random._pickle", "__bit_generator_ctor"): random_pickle.__bit_generator_ctor,
        ("numpy.random._mt19937", "MT19937"): np.random.MT19937,
    }
    for package in ("numpy._core", "numpy.core"):
        for name in ("multiarray._reconstruct", "multiarray.scalar", "numeric._frombuffer"):
            module, attr = name.rsplit(".", 1)
            allowed[(f"{package}.{module}", attr)] = _numpy_function(name)
    return allowed


ALLOWED = _allowed()


class RestrictedUnpickler(pickle.Unpickler):
    """An unpickler that resolves only the globals of ``ALLOWED``."""

    def find_class(self, module, name):
        try:
            return ALLOWED[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(f"the forest pickle refers to {module}.{name}, which is not among the "
                                         "globals a pickled sklearn forest holds") from None


def load(file) -> Any:
    """Unpickle a sklearn forest from an open binary file with the stand-in classes."""
    return RestrictedUnpickler(file).load()


# the globals the writer emits, by the object that stands for each
GLOBAL_NAMES = {
    RandomForestClassifier: ("sklearn.ensemble._forest", "RandomForestClassifier"),
    DecisionTreeClassifier: ("sklearn.tree._classes", "DecisionTreeClassifier"),
    Tree: ("sklearn.tree._tree", "Tree"),
    np.dtype: ("numpy", "dtype"),
    np.ndarray: ("numpy", "ndarray"),
    _numpy_function("multiarray._reconstruct"): ("numpy._core.multiarray", "_reconstruct"),
    _numpy_function("multiarray.scalar"): ("numpy._core.multiarray", "scalar"),
}
PROTOCOL = 4


class Pickler(pickle._Pickler):
    """The standard library's pure-Python pickler, writing the globals of ``GLOBAL_NAMES`` by name
    without importing their modules, and numpy objects as numpy 2 reduces them."""

    def save_global(self, obj, name=None):
        ref = GLOBAL_NAMES.get(obj)
        if ref is None:
            raise pickle.PicklingError(f"a sklearn forest pickle holds no global {obj!r}")
        self.save(ref[0])
        self.save(ref[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)

    # the base class dispatches Python functions to its own save_global
    dispatch = {**pickle._Pickler.dispatch, types.FunctionType: save_global}

    def reducer_override(self, obj):
        if isinstance(obj, np.ndarray):
            if obj.dtype.hasobject:
                raise pickle.PicklingError("a sklearn forest pickle holds no object arrays")
            # ndarray.__reduce__: the array rebuilt from its C-order bytes
            return (_numpy_function("multiarray._reconstruct"), (np.ndarray, (0,), b"b"),
                    (1, obj.shape, obj.dtype, False, np.ascontiguousarray(obj).tobytes()))
        if isinstance(obj, np.dtype):
            return obj.__reduce__()
        if isinstance(obj, np.generic):
            return _numpy_function("multiarray.scalar"), (obj.dtype, obj.tobytes())
        return NotImplemented


def dumps(obj) -> bytes:
    """Pickle a graph of the stand-in classes, numpy objects and plain Python values as sklearn's
    objects (protocol 4)."""
    buffer = io.BytesIO()
    Pickler(buffer, protocol=PROTOCOL).dump(obj)
    return buffer.getvalue()
