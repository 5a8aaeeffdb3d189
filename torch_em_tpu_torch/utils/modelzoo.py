"""bioimage.io model packages: export, validation and import.

The port's own copy of ``torch_em_tpu/utils/modelzoo.py`` (after torch-em's
``util/modelzoo.py``). ``export_bioimageio_model`` turns a trainer's
checkpoint into a model package: ``rdf.yaml``, the weights as a
``pytorch_state_dict`` entry (``weights.pt``, the model's ``state_dict``),
``test_input.npy`` and ``test_output.npy`` (float32, computed in float32 with
TF32 off, so that the package validates on the CPU as on the card), the
preprocessing that the trainer's normalizer implies, ``model_manifest.json``
and ``documentation.md``. The U-Net family and UNETR keep torch-em's
architecture names (``torch_em.model.unet.UNet2d`` and so on), whose
parameter names the port's models share, so torch-em loads these packages;
other models name the port's factory. The port has no flax, so it writes no
``jax`` weight entry.

``import_bioimageio_model`` reads a package folder, its ``rdf.yaml`` or a
``.zip``: a ``pytorch_state_dict`` entry (the port's, torch-em's or the JAX
package's, whose torch-em architecture names map onto the port's factories)
or a ``torchscript`` entry; a package whose only weights are ``jax`` raises
``NotImplementedError``. ``add_weight_formats`` adds ``torchscript`` (the
port's model traced on the CPU, see ``_export_torchscript``) or ``onnx``
(which needs the onnx package). ``get_mws_config`` and
``get_shallow2deep_config`` build the tool configs; ``main`` and
``convert_main`` are the command lines. YAML goes through
``bioimageio_spec.read_rdf`` and ``write_rdf`` (PyYAML where installed).
"""

import contextlib
import json
import os
import shutil
import tempfile
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np
import torch

from .bioimageio_spec import rdf_path, read_rdf, validate_model_rdf, write_rdf
from .util import get_normalizer, get_trainer

__all__ = [
    "export_bioimageio_model", "import_bioimageio_model", "get_default_citations", "get_mws_config",
    "get_shallow2deep_config", "export_parser_helper", "add_weight_formats", "convert_to_onnx", "main",
    "convert_main",
]

# the port's factories and torch-em's constructors of the same architecture and parameter names
_TORCH_ARCHITECTURES = {
    "torch_em_tpu_torch.models.unet.UNet2d": "torch_em.model.unet.UNet2d",
    "torch_em_tpu_torch.models.unet.UNet3d": "torch_em.model.unet.UNet3d",
    "torch_em_tpu_torch.models.unet.AnisotropicUNet": "torch_em.model.unet.AnisotropicUNet",
    "torch_em_tpu_torch.models.unetr.UNETR": "torch_em.model.unetr.UNETR",
}
# constructor arguments of the port only: where to build, the initial weights, the compute type
_PORT_ONLY_KWARGS = ("device", "seed", "dtype", "encoder_checkpoint")


def normalize_with_batch(data, normalizer):
    """Normalize a batch sample by sample."""
    if normalizer is None:
        return data
    return np.concatenate([normalizer(da)[None] for da in data], axis=0)


def get_default_citations(model=None, model_output=None) -> List[Dict[str, str]]:
    """The default citations of an export: the library, the architecture, the decoding."""
    citations = [{"text": "training library", "doi": "10.5281/zenodo.5108853"}]
    if model in ("UNet2d", "UNet3d", "AnisotropicUNet"):
        citations.append({"text": "architecture", "doi": "10.1007/978-3-319-24574-4_28"})
    elif model == "UNETR":
        citations.append({"text": "architecture", "doi": "10.48550/arXiv.2103.10504"})
    if model_output == "affinities":
        citations.append({"text": "segmentation algorithm", "doi": "10.1109/TPAMI.2020.2980827"})
    elif model_output == "boundaries":
        citations.append({"text": "segmentation algorithm", "doi": "10.1038/nmeth.4151"})
    return citations


def _plain(value):
    """``value`` with numpy scalars, arrays and tuples as Python numbers and lists."""
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, np.ndarray):
        return _plain(value.tolist())
    if isinstance(value, np.generic):
        return value.item()
    return value


def _dataset_ndim(dataset) -> int:
    while hasattr(dataset, "datasets"):
        dataset = dataset.datasets[0]
    return dataset.ndim


def _get_preprocessing(trainer):
    """The bioimage.io preprocessing of the trainer's normalizer, or None."""
    from ..transforms import raw as raw_transforms

    normalizer = get_normalizer(trainer)
    fn = getattr(normalizer, "func", normalizer)
    kwargs = getattr(normalizer, "keywords", {})
    name = getattr(fn, "__name__", str(fn))
    axes = "cyx" if _dataset_ndim(trainer.train_loader.dataset) == 2 else "czyx"
    if name == "standardize" or fn is raw_transforms.standardize:
        mode = "fixed" if ("mean" in kwargs and "std" in kwargs) else "per_sample"
        return [{"name": "zero_mean_unit_variance", "kwargs": {"mode": mode, "axes": axes, **kwargs}}]
    if name == "normalize_percentile" or fn is raw_transforms.normalize_percentile:
        return [{"name": "scale_range", "kwargs": {
            "mode": "per_sample", "axes": axes, "min_percentile": kwargs.get("lower", 1.0),
            "max_percentile": kwargs.get("upper", 99.0)}}]
    if name == "normalize" or fn is raw_transforms.normalize:
        return [{"name": "scale_range", "kwargs": {
            "mode": "per_sample", "axes": axes, "min_percentile": 0.0, "max_percentile": 100.0}}]
    return None


def _get_input_data(trainer):
    """One input sample of the trainer's validation loader."""
    x, _ = next(iter(trainer.val_loader))
    return np.asarray(x[0:1])


def _model_device(model) -> torch.device:
    return next(iter(model.parameters())).device


@contextlib.contextmanager
def _float32(model):
    """Exact float32 for a forward: the model's compute dtype float32, TF32 off."""
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    dtype = getattr(model, "dtype", None)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    if isinstance(dtype, torch.dtype):
        model.dtype = torch.float32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        if isinstance(dtype, torch.dtype):
            model.dtype = dtype


def _forward_float32(model, x: np.ndarray) -> np.ndarray:
    """The model's float32 output (TF32 off) for a numpy batch, computed on its device."""
    with _float32(model), torch.inference_mode():
        out = model(torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(_model_device(model)))
    return out.float().cpu().numpy()


def _architecture_kwargs(model) -> Dict:
    """The model's constructor arguments as the package records them: JSON values, without the
    port's own (device, seed, compute dtype, encoder checkpoint)."""
    kwargs = {k: v for k, v in model.init_kwargs.items() if k not in _PORT_ONLY_KWARGS}
    return json.loads(json.dumps(_plain(kwargs), default=str))


def _architecture(model) -> Dict:
    factory = model.factory
    target = _TORCH_ARCHITECTURES.get(factory, factory)
    module, callable_name = target.rsplit(".", 1)
    return {"callable": callable_name, "import_from": module, "kwargs": _architecture_kwargs(model)}


def _rebuild_with_postprocessing(model, postprocessing):
    from ..trainer.serialization import resolve_path

    kwargs = dict(model.init_kwargs, postprocessing=postprocessing)
    kwargs["device"] = str(_model_device(model))
    new_model = resolve_path(model.factory)(**kwargs)
    new_model.load_state_dict(model.state_dict())
    return new_model.eval()


def export_bioimageio_model(
    checkpoint: str,
    output_path: str,
    input_data: Optional[np.ndarray] = None,
    name: Optional[str] = None,
    description: Optional[str] = None,
    authors: Optional[List[Dict]] = None,
    tags: Optional[List[str]] = None,
    license: str = "CC-BY-4.0",
    documentation: Optional[str] = None,
    git_repo: Optional[str] = None,
    cite: Optional[List[Dict]] = None,
    input_optional_parameters: bool = False,
    model_postprocessing: Optional[str] = None,
    for_deepimagej: bool = False,
    links: Optional[List[str]] = None,
    maintainers: Optional[List[Dict]] = None,
    min_shape=None,
    halo=None,
    checkpoint_name: str = "best",
    config: Optional[Dict] = None,
    device="cuda",
) -> bool:
    """Export the model of a trainer's checkpoint folder as a bioimage.io model package in the
    folder ``output_path`` (without a ``.zip`` ending); the test output is computed on
    ``device``. Returns whether the package validates (``_validate_model``)."""
    trainer = get_trainer(checkpoint, name=checkpoint_name, device=device)
    model = trainer.model.eval()
    if model_postprocessing is not None:
        model = _rebuild_with_postprocessing(model, model_postprocessing)

    export_folder = output_path[:-4] if output_path.endswith(".zip") else output_path
    os.makedirs(export_folder, exist_ok=True)

    if input_data is None:
        input_data = _get_input_data(trainer)
    input_data = np.asarray(input_data)
    while input_data.ndim < _dataset_ndim(trainer.train_loader.dataset) + 2:
        input_data = input_data[None]
    test_input = normalize_with_batch(input_data, get_normalizer(trainer)).astype(np.float32)
    test_output = _forward_float32(model, test_input)
    np.save(os.path.join(export_folder, "test_input.npy"), test_input)
    np.save(os.path.join(export_folder, "test_output.npy"), test_output)

    weights_path = os.path.join(export_folder, "weights.pt")
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, weights_path)
    architecture = _architecture(model)
    manifest = {"factory": model.factory, "kwargs": architecture["kwargs"]}
    with open(os.path.join(export_folder, "model_manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)

    if documentation is None:
        doc_path = os.path.join(export_folder, "documentation.md")
        with open(doc_path, "w") as f:
            f.write(f"# {name or 'exported model'}\n\nExported from a tpu-em (PyTorch) checkpoint.\n")
    else:
        doc_path = documentation

    axes = "bcyx" if test_input.ndim == 4 else "bczyx"
    preprocessing = _get_preprocessing(trainer)
    rdf = {
        "format_version": "0.4.10",
        "type": "model",
        "timestamp": datetime.now().isoformat(),
        "name": name or os.path.basename(os.path.normpath(str(checkpoint))),
        "description": description or "Model exported from tpu-em (PyTorch).",
        "authors": authors or [{"name": "tpu-em"}],
        "cite": cite or get_default_citations(architecture["callable"]),
        "license": license,
        "documentation": os.path.basename(doc_path),
        "tags": tags or ["segmentation"],
        "inputs": [{
            "name": "input0", "axes": axes, "data_type": "float32", "shape": list(test_input.shape),
            **({"preprocessing": preprocessing} if preprocessing else {}),
        }],
        "outputs": [{
            "name": "output0", "axes": axes, "data_type": "float32", "shape": list(test_output.shape),
            **({"halo": list(halo)} if halo is not None else {}),
        }],
        "test_inputs": ["test_input.npy"],
        "test_outputs": ["test_output.npy"],
        "weights": {"pytorch_state_dict": {
            "source": os.path.basename(weights_path), "architecture": architecture,
            "pytorch_version": str(torch.__version__).split("+")[0],
        }},
        "config": {} if config is None else config,
    }
    if git_repo is not None:
        rdf["git_repo"] = git_repo
    if links:
        rdf["links"] = links
    if maintainers:
        rdf["maintainers"] = maintainers
    write_rdf(_plain(rdf), os.path.join(export_folder, "rdf.yaml"))
    return _validate_model(export_folder, device=device)


def _validate_model(export_folder: str, device="cuda") -> bool:
    """The package's spec checks (``validate_model_rdf``), then its import on ``device`` and
    its test output within 1e-4 in float32 (TF32 off), as bioimageio.core's test does."""
    import warnings

    errors, spec_warnings = validate_model_rdf(export_folder)
    for w in spec_warnings:
        warnings.warn(f"bioimage.io spec: {w}")
    if errors:
        warnings.warn(f"bioimage.io spec validation failed: {errors}")
        return False
    try:
        model, _ = import_bioimageio_model(export_folder, device=device)
        test_input = np.load(os.path.join(export_folder, "test_input.npy"))
        test_output = np.load(os.path.join(export_folder, "test_output.npy"))
        return bool(np.allclose(_forward_float32(model, test_input), test_output, atol=1e-4))
    except Exception as e:
        warnings.warn(f"Model validation failed: {e}")
        return False


def _package_folder(spec_path: str) -> str:
    """The folder of a package given as a folder, its rdf or a ``.zip`` (unpacked to a
    temporary folder)."""
    spec_path = str(spec_path)
    if os.path.isfile(spec_path) and spec_path.endswith(".zip"):
        folder = tempfile.mkdtemp(prefix="tpu_em_torch_import_")
        shutil.unpack_archive(spec_path, folder)
        return folder
    return spec_path if os.path.isdir(spec_path) else os.path.dirname(spec_path)


def _read_package_rdf(folder: str) -> Dict:
    path = rdf_path(folder)
    if path is None:
        raise FileNotFoundError(f"No rdf.yaml / bioimageio.yaml in {folder}")
    return read_rdf(path)


def import_bioimageio_model(spec_path: str, return_spec: bool = False, device="cuda"):
    """The model of a package (folder, ``rdf.yaml`` or ``.zip``) on ``device`` in eval mode,
    and its normalizer (and the rdf with ``return_spec``)."""
    from ..models.base import resolve_device

    device = resolve_device(device)
    folder = _package_folder(spec_path)
    rdf = _read_package_rdf(folder)
    weights = rdf.get("weights") or {}
    if "pytorch_state_dict" in weights:
        model = _import_torch_package(folder, weights["pytorch_state_dict"], device)
    elif "torchscript" in weights:
        model = torch.jit.load(os.path.join(folder, weights["torchscript"]["source"]), map_location=device)
    elif "jax" in weights:
        raise NotImplementedError(
            "This package carries only 'jax' (flax) weights, which the PyTorch port cannot read; add a "
            "pytorch_state_dict entry with the JAX package's add_weight_formats(package, "
            "['pytorch_state_dict']) first.")
    else:
        raise NotImplementedError(f"Package carries none of the supported weight formats "
                                  f"(pytorch_state_dict, torchscript): {sorted(weights)}")
    model.eval()
    normalizer = _load_normalizer(rdf)
    if return_spec:
        return model, normalizer, rdf
    return model, normalizer


def _factory_path(architecture) -> str:
    """The port's factory of a ``pytorch_state_dict`` architecture entry: the port's own path,
    or the port's model of a torch-em (or JAX package) architecture name."""
    from ..trainer.serialization import resolve_path

    if isinstance(architecture, dict):
        module, name = architecture.get("import_from") or "", architecture.get("callable") or ""
    else:  # bioimage.io 0.4 style: "unet.py:UNet2d" or a dotted path
        module, _, name = str(architecture or "").replace(":", ".").rpartition(".")
    if module.startswith("torch_em_tpu_torch."):
        path = f"{module}.{name}"
        resolve_path(path)
        return path
    by_name = {v.rsplit(".", 1)[-1]: k for k, v in _TORCH_ARCHITECTURES.items()}
    if name not in by_name:
        raise NotImplementedError(f"Cannot import the architecture {module}.{name}; the port builds "
                                  f"{sorted(by_name)} and its own models")
    return by_name[name]


def _import_torch_package(folder, entry, device):
    """The port's model of a ``pytorch_state_dict`` entry, with the package's weights."""
    from ..trainer.serialization import resolve_path

    architecture = entry.get("architecture")
    kwargs = (architecture.get("kwargs") if isinstance(architecture, dict) else None) or entry.get("kwargs") or {}
    kwargs = {k: v for k, v in kwargs.items() if not (k == "postprocessing" and v is None)}
    model = resolve_path(_factory_path(architecture))(**kwargs, device=device)
    source = os.path.basename(str(entry.get("source", "weights.pt")))
    state = torch.load(os.path.join(folder, source), map_location=device, weights_only=True)
    if isinstance(state, dict) and "model_state" in state:
        state = state["model_state"]
    model.load_state_dict(state)
    return model


def _load_normalizer(rdf):
    """The normalizer of the package's preprocessing (``standardize`` without one)."""
    from functools import partial

    from ..transforms.raw import normalize, normalize_percentile, standardize

    preprocessing = rdf["inputs"][0].get("preprocessing")
    if not preprocessing:
        return standardize
    spec = preprocessing[0]
    # this package writes "name"; bioimage.io 0.5 rdfs write "id"
    name, kwargs = spec.get("name") or spec.get("id"), spec.get("kwargs", {})
    if name == "zero_mean_unit_variance":
        if kwargs.get("mode") == "fixed":
            return partial(standardize, mean=kwargs.get("mean"), std=kwargs.get("std"))
        return standardize
    if name == "scale_range":
        lower, upper = kwargs.get("min_percentile", 0.0), kwargs.get("max_percentile", 100.0)
        if lower == 0.0 and upper == 100.0:
            return normalize
        return partial(normalize_percentile, lower=lower, upper=upper)
    return standardize


def _package_model_on_cpu(folder):
    """The package's model on the CPU, with its test input (or a random input of its shape)."""
    model, _ = import_bioimageio_model(folder, device="cpu")
    if not isinstance(model, torch.nn.Module) or isinstance(model, torch.jit.ScriptModule):
        raise NotImplementedError("the package has no pytorch_state_dict entry to convert")
    if getattr(model, "return_side_outputs", False):
        raise NotImplementedError("torchscript and onnx exports take one output, not side outputs")
    example_path = os.path.join(folder, "test_input.npy")
    if os.path.exists(example_path):
        example = np.load(example_path).astype(np.float32)
    else:
        shape = _read_package_rdf(folder)["inputs"][0]["shape"]
        example = np.random.RandomState(0).rand(*shape).astype(np.float32)
    return model, example


def _export_torchscript(folder):
    """Trace the package's model and store it as the ``torchscript`` weights
    (``weights_torchscript.pt``).

    The trace runs on the CPU, where the port's instance norm is its plain
    PyTorch version: the traced program holds plain ops only, so the package
    runs wherever PyTorch does, also where the port's CUDA kernels are not
    built. A trace records cuDNN's TF32 flag in each convolution; it is
    traced with TF32 off, so that its convolutions compute in float32 on a
    card, as the package's test output was computed. It is held against the
    model on the package's test input within 1e-4 before it is written."""
    model, example = _package_model_on_cpu(folder)
    x = torch.from_numpy(example)
    with _float32(model), torch.no_grad():
        traced = torch.jit.trace(model, x, check_trace=False)
        out_model, out_traced = model(x).numpy(), traced(x).numpy()
    if not np.allclose(out_model, out_traced, atol=1e-4):
        raise RuntimeError(f"the torchscript trace diverges from the model "
                           f"(max |d| = {np.abs(out_model - out_traced).max():.3e})")
    weights_path = os.path.join(folder, "weights_torchscript.pt")
    traced.save(weights_path)
    return weights_path, {"pytorch_version": str(torch.__version__).split("+")[0]}


def convert_to_onnx(spec_path, opset_version=12):
    """Write the package's model as ONNX weights (``weights.onnx``) and add their entry; needs
    the onnx package."""
    try:
        import onnx  # noqa: F401  (torch's exporter serializes through it)
    except ImportError as e:
        raise ImportError("converting a package to ONNX needs the onnx package, which is not installed; "
                          "the torchscript format (add_weight_formats(..., ['torchscript'])) needs "
                          "nothing beyond PyTorch") from e
    folder = spec_path if os.path.isdir(spec_path) else os.path.dirname(spec_path)
    model, example = _package_model_on_cpu(folder)
    out_path = os.path.join(folder, "weights.onnx")
    with torch.no_grad():
        torch.onnx.export(model, (torch.from_numpy(example),), out_path, opset_version=opset_version,
                          dynamo=False, input_names=["input"], output_names=["output"])
    _add_weight_entry(folder, "onnx", {"source": os.path.basename(out_path), "opset_version": opset_version})
    return out_path


def _add_weight_entry(folder, fmt, entry):
    path = rdf_path(folder)
    rdf = read_rdf(path)
    rdf.setdefault("weights", {})[fmt] = entry
    write_rdf(rdf, path)


def add_weight_formats(model_path, additional_formats):
    """Add weight formats to a package: ``torchscript`` or ``onnx``; ``pytorch_state_dict``
    is there from the export already."""
    folder = model_path if os.path.isdir(model_path) else os.path.dirname(model_path)
    for fmt in additional_formats:
        if fmt in ("pytorch_state_dict", "pytorch", "torch"):
            weights = _read_package_rdf(folder).get("weights") or {}
            if "pytorch_state_dict" not in weights:
                raise NotImplementedError(
                    "the package has no pytorch_state_dict entry to start from; a package with only 'jax' "
                    "weights gets one from the JAX package's add_weight_formats(package, "
                    "['pytorch_state_dict'])")
        elif fmt == "torchscript":
            weights_path, extra = _export_torchscript(folder)
            _add_weight_entry(folder, "torchscript", {"source": os.path.basename(weights_path), **extra})
        elif fmt == "onnx":
            convert_to_onnx(folder)
        else:
            raise NotImplementedError(f"Weight format {fmt} is not supported by the PyTorch port.")


def get_mws_config(offsets, config=None) -> Dict:
    """The mutex watershed's tool config."""
    config = {} if config is None else config
    config.update({"mws": {"offsets": offsets}})
    return config


def get_shallow2deep_config(rf_path, config=None) -> Dict:
    """The Shallow2Deep tool config of a forest (``.npz`` or ``.pkl``; of a folder, its first
    forest): its feature dimensionality and filter config."""
    from ..shallow2deep.forest import forest_paths, load_forest

    if os.path.isdir(rf_path):
        candidates = forest_paths(rf_path)
        assert candidates, f"No rf found in {rf_path}"
        rf_path = candidates[0]
    forest = load_forest(rf_path)
    config = {} if config is None else config
    config.update({"shallow2deep": {"ndim": forest.feature_ndim, "features": forest.feature_config}})
    return config


def export_parser_helper():
    """The arguments of the export command line."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("-i", "--input", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("-a", "--affs_to_bd", default=0, type=int)
    parser.add_argument("-f", "--additional_formats", type=str, nargs="+")
    parser.add_argument("-d", "--device", default="cuda")
    return parser


def _load_input(path, key):
    from .io import load_data

    return np.asarray(load_data(path, key)[:])


def main():
    """Command line: ``tpu_em_torch.export_bioimageio_model -c checkpoint -i input[,key] -o output``."""
    args = export_parser_helper().parse_args()
    path, key = args.input.split(",") if "," in args.input else (args.input, None)
    postprocessing = "affinities_to_boundaries2d" if bool(args.affs_to_bd) else None
    export_bioimageio_model(args.checkpoint, args.output, _load_input(path, key),
                            model_postprocessing=postprocessing, device=args.device)
    if args.additional_formats:
        add_weight_formats(args.output, args.additional_formats)


def convert_main():
    """Command line: ``tpu_em_torch.convert_weights -m package -w weight_format``."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model", required=True)
    parser.add_argument("-w", "--weight_format", required=True)
    args = parser.parse_args()
    add_weight_formats(args.model, [args.weight_format])
