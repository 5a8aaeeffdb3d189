"""Checkpoint (de)serialization of constructor data: the config system.

The port's own copy of ``torch_em_tpu/trainer/serialization.py``. A trainer
checkpoint carries every constructor argument of the trainer as a JSON spec
tree, so that ``DefaultTrainer.from_checkpoint`` rebuilds a trainer that can
go on training, data loaders included:

- builtins pass through; tuples, lists and dicts recurse;
- functions and classes become ``{"__callable__": "module.qualname"}``;
- objects with ``init_kwargs`` become ``{"__instance__": path, "kwargs"}``;
- models built by a factory (``model.factory``, ``model.init_kwargs``)
  become ``{"__model__": factory, "kwargs"}``;
- data loaders become their dataset's spec and the loader's arguments;
- ``torch.dtype``s, numpy dtypes, slices, partials and small numpy arrays
  have their own tags.

``serialize_value_or_pickle`` falls back to an inline pickle for what has no
spec; ``deserialize_value`` unpickles only such blobs, which a trainer of
this package wrote.
"""

import base64
import functools
import importlib
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["serialize_value", "serialize_value_or_pickle", "deserialize_value",
           "resolve_path", "path_of"]


def path_of(obj) -> str:
    """Dotted import path of a function / class."""
    module = getattr(obj, "__module__", None)
    name = getattr(obj, "__qualname__", getattr(obj, "__name__", None))
    if module is None or name is None or "<locals>" in name:
        raise ValueError(f"Cannot serialize {obj!r}: not importable by dotted path.")
    return f"{module}.{name}"


def resolve_path(path: str):
    module_name, _, qualname = path.rpartition(".")
    obj = importlib.import_module(module_name)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _kwargs_spec(kwargs) -> dict:
    return {k: serialize_value(v) for k, v in dict(kwargs).items()}


def serialize_value(value) -> Any:
    from ..data.loader import DataLoader

    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, tuple):
        return {"__tuple__": [serialize_value(v) for v in value]}
    if isinstance(value, list):
        return [serialize_value(v) for v in value]
    if isinstance(value, dict):
        return {"__dict__": _kwargs_spec(value)}
    if isinstance(value, slice):
        return {"__slice__": [value.start, value.stop, value.step]}
    if isinstance(value, torch.dtype):
        return {"__torch_dtype__": str(value).removeprefix("torch.")}
    if isinstance(value, np.dtype):
        return {"__dtype__": str(value)}
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, np.ndarray):
        if value.size > 1_000_000:
            raise ValueError("Refusing to inline-serialize arrays larger than 1M elements.")
        return {"__ndarray__": value.tolist(), "dtype": str(value.dtype)}
    if isinstance(value, torch.nn.Module):
        if not isinstance(getattr(value, "factory", None), str):
            raise ValueError("Model has no .factory path; cannot serialize.")
        return {"__model__": value.factory, "kwargs": _kwargs_spec(value.init_kwargs)}
    if isinstance(value, DataLoader):
        return {"__loader__": {"dataset": serialize_value(value.dataset),
                               "kwargs": _kwargs_spec(value.init_kwargs)}}
    if isinstance(value, functools.partial):
        return {"__partial__": {
            "func": path_of(value.func),
            "args": [serialize_value(a) for a in value.args],
            "keywords": _kwargs_spec(value.keywords),
        }}
    if hasattr(value, "init_kwargs"):
        # objects built by a factory function record it in a `.factory` path
        target = value.factory if isinstance(getattr(value, "factory", None), str) else path_of(type(value))
        return {"__instance__": target, "kwargs": _kwargs_spec(value.init_kwargs)}
    if callable(value):
        return {"__callable__": path_of(value)}
    raise ValueError(f"Cannot serialize value of type {type(value)}: {value!r}")


def serialize_value_or_pickle(value) -> Any:
    """``serialize_value``, else an inline pickle; raises ValueError when neither works."""
    try:
        return serialize_value(value)
    except ValueError:
        try:
            blob = pickle.dumps(value)
        except Exception as e:
            raise ValueError(f"Cannot serialize {type(value)} by dotted path nor pickle: {e}")
        return {"__pickle__": base64.b64encode(blob).decode("ascii")}


def _deserialize_kwargs(spec) -> dict:
    return {k: deserialize_value(v) for k, v in spec.items()}


def deserialize_value(spec) -> Any:
    if spec is None or isinstance(spec, (bool, int, float, str)):
        return spec
    if isinstance(spec, list):
        return [deserialize_value(v) for v in spec]
    if not isinstance(spec, dict):
        raise ValueError(f"Cannot deserialize spec of type {type(spec)}")
    if "__tuple__" in spec:
        return tuple(deserialize_value(v) for v in spec["__tuple__"])
    if "__dict__" in spec:
        return _deserialize_kwargs(spec["__dict__"])
    if "__slice__" in spec:
        return slice(*spec["__slice__"])
    if "__torch_dtype__" in spec:
        return getattr(torch, spec["__torch_dtype__"])
    if "__dtype__" in spec:
        return np.dtype(spec["__dtype__"])
    if "__ndarray__" in spec:
        return np.asarray(spec["__ndarray__"], dtype=spec["dtype"])
    if "__callable__" in spec:
        return resolve_path(spec["__callable__"])
    if "__pickle__" in spec:
        return pickle.loads(base64.b64decode(spec["__pickle__"]))
    if "__partial__" in spec:
        p = spec["__partial__"]
        return functools.partial(resolve_path(p["func"]), *[deserialize_value(a) for a in p["args"]],
                                 **_deserialize_kwargs(p["keywords"]))
    if "__instance__" in spec:
        return resolve_path(spec["__instance__"])(**_deserialize_kwargs(spec["kwargs"]))
    if "__model__" in spec:
        return resolve_path(spec["__model__"])(**_deserialize_kwargs(spec["kwargs"]))
    if "__loader__" in spec:
        from ..data.loader import DataLoader

        dataset = deserialize_value(spec["__loader__"]["dataset"])
        return DataLoader(dataset, **_deserialize_kwargs(spec["__loader__"]["kwargs"]))
    raise ValueError(f"Cannot deserialize spec with keys {list(spec.keys())}")
