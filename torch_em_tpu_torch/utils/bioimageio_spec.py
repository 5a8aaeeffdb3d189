"""Vendored checks of the bioimage.io model RDF, and its reading and writing.

The port's own copy of ``torch_em_tpu/utils/bioimageio_spec.py``. The
bioimageio.spec and bioimageio.core libraries that torch-em validates its
exports with are not installed, so this module keeps the rules of the model
RDF ``format_version 0.4.x`` (what ``export_bioimageio_model`` writes) as
plain checks: required fields, axes strings, shapes against the test tensors
on disk, the weight entries' files, authors and citations, and SPDX license
ids. It validates the package (the rdf and its files), as
``bioimageio.spec.load_description`` and ``bioimageio.core.test_model`` do
together. ``validate_model_rdf`` returns (errors, warnings): errors are what
the official tooling would reject, warnings what it would tolerate.

``write_rdf`` writes ``rdf.yaml`` with PyYAML's ``safe_dump`` where PyYAML is
installed and, where it is not, as JSON text (``rdf_to_json_yaml``), which is
YAML too: floats keep a dot and a signed exponent (``1.0e-05``), since YAML
1.1, which PyYAML reads, takes ``1e-05`` for a string. ``read_rdf`` reads
with PyYAML where installed and as JSON otherwise; a block-style rdf then
raises an ``ImportError`` naming PyYAML.
"""

import json
import math
import os
from typing import Any, Dict, List, Tuple, Union

import numpy as np

__all__ = ["validate_model_rdf", "SPEC_WEIGHT_FORMATS", "read_rdf", "write_rdf", "rdf_path", "rdf_to_json_yaml"]

# weight formats defined by the 0.4 model spec
SPEC_WEIGHT_FORMATS = (
    "keras_hdf5", "onnx", "pytorch_state_dict", "tensorflow_js",
    "tensorflow_saved_model_bundle", "torchscript",
)

_AXES_CHARS = set("bitczyx")

# common SPDX ids seen on bioimage.io; unknown ids are a warning (the spec
# validates against the full SPDX list, which is not vendored here)
_KNOWN_LICENSES = {
    "CC0-1.0", "CC-BY-4.0", "CC-BY-NC-4.0", "CC-BY-SA-4.0", "MIT", "BSD-2-Clause",
    "BSD-3-Clause", "Apache-2.0", "GPL-2.0-only", "GPL-3.0-only", "GPL-3.0-or-later",
    "LGPL-3.0-only", "MPL-2.0", "AGPL-3.0-only", "Unlicense",
}


def rdf_path(folder: str):
    """The package's ``rdf.yaml`` (or ``bioimageio.yaml``), or None."""
    return next((p for n in ("rdf.yaml", "bioimageio.yaml") if os.path.exists(p := os.path.join(folder, n))), None)


def _json_float(x: float) -> str:
    if not math.isfinite(x):
        raise ValueError(f"an rdf holds no {x}")
    text = repr(float(x))
    if "e" not in text:
        return text
    mantissa, exponent = text.split("e")
    if "." not in mantissa:
        mantissa += ".0"
    return f"{mantissa}e{exponent if exponent[0] in '+-' else '+' + exponent}"


def _json_text(value: Any, indent: int) -> str:
    pad, inner = " " * indent, " " * (indent + 2)
    if isinstance(value, bool) or value is None or isinstance(value, (int, str)):
        return json.dumps(value)
    if isinstance(value, float):
        return _json_float(value)
    if isinstance(value, dict):
        if not value:
            return "{}"
        items = [f"{inner}{json.dumps(str(k))}: {_json_text(v, indent + 2)}" for k, v in value.items()]
        return "{\n" + ",\n".join(items) + "\n" + pad + "}"
    if isinstance(value, (list, tuple)):
        if not value:
            return "[]"
        return "[\n" + ",\n".join(inner + _json_text(v, indent + 2) for v in value) + "\n" + pad + "]"
    raise TypeError(f"an rdf holds no {type(value).__name__}: {value!r}")


def rdf_to_json_yaml(rdf: Dict) -> str:
    """The rdf as JSON text that YAML 1.1 reads as the same values."""
    return _json_text(rdf, 0) + "\n"


def write_rdf(rdf: Dict, path: str) -> None:
    """Write ``rdf`` to ``path``: PyYAML's ``safe_dump`` where installed, else JSON text."""
    try:
        import yaml
    except ImportError:
        text = rdf_to_json_yaml(rdf)
    else:
        text = yaml.safe_dump(rdf)
    with open(path, "w") as f:
        f.write(text)


def read_rdf(path: str) -> Dict:
    """The rdf of ``path``: read by PyYAML where installed, else as JSON."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise ImportError(f"reading {path}, which is not JSON, needs PyYAML (yaml), which is not "
                              "installed") from e
    return yaml.safe_load(text)


def _check_tensor_specs(specs, kind: str, folder: str, test_files, errors, warnings):
    if not isinstance(specs, list) or not specs:
        errors.append(f"'{kind}' must be a non-empty list")
        return
    for i, spec in enumerate(specs):
        where = f"{kind}[{i}]"
        if not isinstance(spec, dict):
            errors.append(f"{where} must be a mapping")
            continue
        if not (spec.get("name") or spec.get("id")):
            errors.append(f"{where} missing 'name'")
        axes = spec.get("axes")
        if not isinstance(axes, str) or not axes:
            errors.append(f"{where} missing 'axes' string")
            axes = None
        elif not set(axes) <= _AXES_CHARS:
            errors.append(f"{where} axes {axes!r} has characters outside 'bitczyx'")
        if spec.get("data_type") not in ("float32", "float64", "uint8", "int8",
                                         "uint16", "int16", "uint32", "int32",
                                         "uint64", "int64", "bool"):
            errors.append(f"{where} data_type {spec.get('data_type')!r} is not a spec dtype")
        shape = spec.get("shape")
        if isinstance(shape, list):
            if axes is not None and len(shape) != len(axes):
                errors.append(f"{where} shape rank {len(shape)} != axes rank {len(axes)}")
        elif isinstance(shape, dict):
            if kind == "inputs" and not ("min" in shape and "step" in shape):
                errors.append(f"{where} parameterized shape needs 'min' and 'step'")
            if kind == "outputs" and "reference_tensor" in shape and not (
                    "scale" in shape and "offset" in shape):
                errors.append(f"{where} implicit shape needs 'scale' and 'offset'")
        else:
            errors.append(f"{where} missing 'shape'")
        halo = spec.get("halo")
        if halo is not None:
            if axes is not None and len(halo) != len(axes):
                errors.append(f"{where} halo rank {len(halo)} != axes rank {len(axes)}")

        # test tensor on disk must match the declared static shape
        if test_files is not None and i < len(test_files):
            path = os.path.join(folder, test_files[i])
            if not os.path.exists(path):
                errors.append(f"test tensor {test_files[i]} for {where} does not exist")
            elif isinstance(shape, list):
                arr_shape = tuple(np.load(path, mmap_mode="r").shape)
                if arr_shape != tuple(shape):
                    errors.append(
                        f"test tensor {test_files[i]} shape {arr_shape} != declared {tuple(shape)}")


def _check_people(entries, field: str, errors):
    if not isinstance(entries, list) or not entries:
        errors.append(f"'{field}' must be a non-empty list")
        return
    for i, a in enumerate(entries):
        if not isinstance(a, dict) or not a.get("name"):
            errors.append(f"{field}[{i}] must be a mapping with a 'name'")


def validate_model_rdf(package: Union[str, Dict]) -> Tuple[List[str], List[str]]:
    """Validate a model package (folder with rdf.yaml, or a loaded rdf dict).

    Returns ``(errors, warnings)``; the package is spec-conformant iff
    ``errors`` is empty.
    """
    errors: List[str] = []
    warnings: List[str] = []

    if isinstance(package, dict):
        rdf, folder = package, None
    else:
        folder = package
        if os.path.isfile(folder):
            folder = os.path.dirname(folder)
        path = rdf_path(folder)
        if path is None:
            return [f"no rdf.yaml / bioimageio.yaml in {folder}"], warnings
        rdf = read_rdf(path)
    if not isinstance(rdf, dict):
        return ["rdf must be a mapping"], warnings

    def exists(rel):
        return folder is None or os.path.exists(os.path.join(folder, rel))

    fv = str(rdf.get("format_version", ""))
    if not fv:
        errors.append("missing 'format_version'")
    elif not (fv.startswith("0.4") or fv.startswith("0.5")):
        warnings.append(f"format_version {fv} is outside the vendored 0.4/0.5 rules")
    if rdf.get("type") != "model":
        errors.append(f"type must be 'model', got {rdf.get('type')!r}")
    for field in ("name", "description"):
        if not isinstance(rdf.get(field), str) or not rdf.get(field):
            errors.append(f"missing '{field}'")
    if "timestamp" not in rdf and fv.startswith("0.4"):
        errors.append("missing 'timestamp' (required by the 0.4 model spec)")

    _check_people(rdf.get("authors"), "authors", errors)
    if rdf.get("maintainers") is not None:
        _check_people(rdf["maintainers"], "maintainers", errors)

    cite = rdf.get("cite")
    if not isinstance(cite, list) or not cite:
        errors.append("'cite' must be a non-empty list")
    else:
        for i, c in enumerate(cite):
            if not isinstance(c, dict) or not c.get("text"):
                errors.append(f"cite[{i}] must be a mapping with 'text'")
            elif not (c.get("doi") or c.get("url")):
                errors.append(f"cite[{i}] needs a 'doi' or 'url'")

    doc = rdf.get("documentation")
    if not isinstance(doc, str):
        errors.append("missing 'documentation'")
    else:
        if not doc.endswith(".md"):
            errors.append(f"documentation must be a markdown file, got {doc!r}")
        if not exists(doc):
            errors.append(f"documentation file {doc!r} does not exist")

    lic = rdf.get("license")
    if not isinstance(lic, str) or not lic:
        errors.append("missing 'license'")
    elif lic not in _KNOWN_LICENSES:
        warnings.append(f"license {lic!r} not in the vendored SPDX subset")

    test_inputs = rdf.get("test_inputs")
    test_outputs = rdf.get("test_outputs")
    if fv.startswith("0.4"):
        if not isinstance(test_inputs, list) or not test_inputs:
            errors.append("'test_inputs' must be a non-empty list")
        if not isinstance(test_outputs, list) or not test_outputs:
            errors.append("'test_outputs' must be a non-empty list")

    _check_tensor_specs(rdf.get("inputs"), "inputs", folder or "",
                        test_inputs if folder else None, errors, warnings)
    _check_tensor_specs(rdf.get("outputs"), "outputs", folder or "",
                        test_outputs if folder else None, errors, warnings)

    weights = rdf.get("weights")
    if not isinstance(weights, dict) or not weights:
        errors.append("'weights' must be a non-empty mapping")
    else:
        standard = [k for k in weights if k in SPEC_WEIGHT_FORMATS]
        for fmt in weights:
            if fmt not in SPEC_WEIGHT_FORMATS:
                warnings.append(
                    f"weight format {fmt!r} is not in the 0.4 spec "
                    f"(framework extension; official tooling ignores or rejects it)")
        if not standard:
            errors.append(
                "no spec-defined weight format present "
                f"(found {sorted(weights)}, spec defines {list(SPEC_WEIGHT_FORMATS)})")
        for fmt, entry in weights.items():
            if not isinstance(entry, dict) or "source" not in entry:
                errors.append(f"weights[{fmt!r}] needs a 'source'")
                continue
            if not exists(entry["source"]):
                errors.append(f"weights[{fmt!r}] source {entry['source']!r} does not exist")
            if fmt == "pytorch_state_dict":
                arch = entry.get("architecture")
                if fv.startswith("0.4"):
                    if not isinstance(arch, (str, dict)):
                        errors.append("weights['pytorch_state_dict'] needs an 'architecture'")
                    elif isinstance(arch, dict) and not (
                            arch.get("callable") and arch.get("import_from")
                            or arch.get("source_file")):
                        errors.append(
                            "pytorch_state_dict architecture needs callable+import_from "
                            "(or source_file)")

    return errors, warnings
