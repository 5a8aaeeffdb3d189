"""bioimage.io packages in the port: export, validation, import, torchscript, the tool configs,
and the interop with the JAX package's packages, on the CPU.

A module fixture builds one JAX package: a small JAX ``UNet2d`` (depth 2, 4
features) with a trainer checkpoint written without a fit (the JAX model's
init under jit, as in ``test_torch_parallel.py``), exported by the JAX
package's ``export_bioimageio_model``. Its ``weights.pt`` and ``rdf.yaml``
must import into the port and reproduce the JAX model's test output within
1e-4 (float32). Another fixture exports a port trainer's checkpoint. The
Shallow2Deep models of both packages run on the same package and the same
forest (the JAX one from the ``.pkl``, the port's from the ``.npz``) within
1e-4.
"""

import importlib
import json
import os
import pickle
import shutil
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from sklearn.ensemble import RandomForestClassifier

import torch_em_tpu as jax_em
from torch_em_tpu.models import UNet2d as JaxUNet2d
from torch_em_tpu.models.base import Model as JaxModel
from torch_em_tpu.shallow2deep import shallow2deep_model as jax_s2d_model
from torch_em_tpu.utils import bioimageio_spec as jax_spec
from torch_em_tpu.utils import modelzoo as jax_modelzoo
from torch_em_tpu.utils import reporting as jax_reporting
import torch_em_tpu_torch as port
from torch_em_tpu_torch.shallow2deep import forest_from_sklearn, save_forest, shallow2deep_model
from torch_em_tpu_torch.utils import bioimageio_spec, modelzoo, reporting

OUTPUT_ATOL = 1e-4
FILTER_CONFIG = [("gaussianSmoothing", 1.0), ("laplacianOfGaussian", 1.6)]


def _jit_initialize(model, rng=None, example=None):
    """``Model.initialize`` under jit: the JAX models' eager init takes tens of seconds."""
    rng = jax.random.PRNGKey(model._seed) if rng is None else rng
    example = jnp.zeros(model.example_input_shape, jnp.float32) if example is None else example
    model.variables = jax.jit(lambda r, x: model.module.init(r, x, train=False))(rng, example)
    return model.variables


def _jit_init():
    return mock.patch.object(JaxModel, "initialize", _jit_initialize)


def _volume(folder):
    rng = np.random.default_rng(0)
    paths = str(folder / "raw.npy"), str(folder / "labels.npy")
    np.save(paths[0], rng.random((4, 64, 64)).astype(np.float32))
    np.save(paths[1], (rng.random((4, 64, 64)) > 0.5).astype(np.float32))
    return paths


@pytest.fixture(scope="module")
def jax_package(tmp_path_factory):
    """(package folder, JAX trainer, data paths) of a JAX export of a small UNet2d."""
    folder = tmp_path_factory.mktemp("jax_export")
    paths = _volume(folder)
    with _jit_init():
        model = JaxUNet2d(in_channels=1, out_channels=1, depth=2, initial_features=4, final_activation="Sigmoid")
        loader = jax_em.default_segmentation_loader(paths[0], None, paths[1], None, batch_size=2,
                                                    patch_shape=(1, 32, 32), ndim=2, n_samples=4)
        trainer = jax_em.default_segmentation_trainer("jx", model, loader, loader, mixed_precision=False,
                                                      device="cpu", logger=None, save_root=str(folder))
        trainer._initialize(1, None)
        trainer.save_checkpoint("best", 0.0, 0.0)
        input_data = np.random.default_rng(1).random((32, 32)).astype(np.float32)
        assert jax_modelzoo.export_bioimageio_model(str(folder / "checkpoints" / "jx"), str(folder / "pkg"),
                                                    input_data=input_data)
    return str(folder / "pkg"), trainer, paths


@pytest.fixture(scope="module")
def port_package(tmp_path_factory):
    """(package folder, port trainer) of a port export of a small UNet2d, and its zip archive."""
    folder = tmp_path_factory.mktemp("port_export")
    paths = _volume(folder)
    torch.manual_seed(0)
    loader = port.default_segmentation_loader(paths[0], None, paths[1], None, batch_size=2, patch_shape=(1, 32, 32),
                                              ndim=2, n_samples=4)
    model = port.UNet2d(1, 1, depth=2, initial_features=4, final_activation="Sigmoid", device="cpu")
    trainer = port.default_segmentation_trainer("pt", model, loader, loader, device="cpu", mixed_precision=False,
                                                save_root=str(folder), learning_rate=1e-3)
    trainer.fit(iterations=2)
    input_data = np.random.default_rng(2).random((1, 32, 32)).astype(np.float32)
    assert modelzoo.export_bioimageio_model(trainer.checkpoint_folder, str(folder / "pkg"), input_data=input_data,
                                            config={"tolerance": 1e-05}, device="cpu")
    shutil.make_archive(str(folder / "pkg"), "zip", str(folder / "pkg"))
    return str(folder / "pkg"), trainer


@pytest.fixture(scope="module")
def forest(tmp_path_factory):
    """A small forest on FILTER_CONFIG's features, pickled (sklearn) and as .npz."""
    folder = tmp_path_factory.mktemp("forest")
    jax_prepare = importlib.import_module("torch_em_tpu.shallow2deep.prepare_shallow2deep")
    image = np.random.default_rng(3).random((48, 48)).astype(np.float32)
    features = jax_prepare._apply_filters(image, jax_prepare._get_filters(2, FILTER_CONFIG))
    rf = RandomForestClassifier(n_estimators=4, random_state=0).fit(features, (image > 0.5).ravel().astype(int))
    rf.feature_ndim, rf.feature_config = 2, FILTER_CONFIG
    with open(folder / "rf_0000.pkl", "wb") as f:
        pickle.dump(rf, f)
    save_forest(forest_from_sklearn(rf), str(folder / "rf_0000.npz"))
    return str(folder / "rf_0000.pkl"), str(folder / "rf_0000.npz")


def test_jax_package_imports_into_port(jax_package):
    folder, _, _ = jax_package
    model, normalizer = modelzoo.import_bioimageio_model(folder, device="cpu")
    assert type(model).__name__ == "UNetModule" and model.factory.endswith("models.unet.UNet2d")
    assert normalizer is port.transforms.raw.standardize
    test_input, expected = np.load(os.path.join(folder, "test_input.npy")), np.load(os.path.join(folder, "test_output.npy"))
    with torch.no_grad():
        got = model(torch.from_numpy(test_input)).numpy()
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=0, atol=OUTPUT_ATOL)


def test_jax_package_zip_imports_into_port(jax_package, tmp_path):
    folder = jax_package[0]
    archive = shutil.make_archive(str(tmp_path / "jax_pkg"), "zip", folder)
    model, _, rdf = modelzoo.import_bioimageio_model(archive, return_spec=True, device="cpu")
    assert rdf["weights"]["pytorch_state_dict"]["architecture"]["import_from"] == "torch_em.model.unet"
    test_input = torch.from_numpy(np.load(os.path.join(folder, "test_input.npy")))
    with torch.no_grad():
        np.testing.assert_allclose(model(test_input).numpy(), np.load(os.path.join(folder, "test_output.npy")),
                                   rtol=0, atol=OUTPUT_ATOL)


def test_jax_only_package_raises(jax_package, tmp_path):
    folder = shutil.copytree(jax_package[0], tmp_path / "jax_only")
    rdf = yaml.safe_load(open(folder / "rdf.yaml"))
    del rdf["weights"]["pytorch_state_dict"]
    yaml.safe_dump(rdf, open(folder / "rdf.yaml", "w"))
    with pytest.raises(NotImplementedError, match=r"add_weight_formats\(package, \['pytorch_state_dict'\]\)"):
        modelzoo.import_bioimageio_model(str(folder), device="cpu")


def test_shallow2deep_model_matches_jax(jax_package, forest):
    folder = jax_package[0]
    batch = np.random.default_rng(4).random((2, 1, 32, 32)).astype(np.float32)
    with _jit_init():
        jax_s2d = jax_s2d_model.Shallow2DeepModel(folder, (forest[0], 2, FILTER_CONFIG))
        expected = np.asarray(jax_s2d(batch))
    port_s2d = shallow2deep_model.Shallow2DeepModel(folder, (forest[1], 2, FILTER_CONFIG), device="cpu")
    got = port_s2d(torch.from_numpy(batch))
    assert got.shape == expected.shape == (2, 1, 32, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, expected, rtol=0, atol=OUTPUT_ATOL)
    np.testing.assert_allclose(port_s2d.rf_prediction(batch),
                               np.stack([jax_s2d.rf_predicter(b[0]) for b in batch])[:, None], rtol=0, atol=1e-6)
    restored = pickle.loads(pickle.dumps(port_s2d))
    np.testing.assert_array_equal(restored(batch), got)


def test_export_import_round_trip(port_package):
    folder, trainer = port_package
    assert sorted(os.listdir(folder)) == ["documentation.md", "model_manifest.json", "rdf.yaml", "test_input.npy",
                                          "test_output.npy", "weights.pt"]
    for source in (folder, os.path.join(folder, "rdf.yaml"), folder + ".zip"):
        model, normalizer = modelzoo.import_bioimageio_model(source, device="cpu")
        assert port.utils.model_is_equal(model, trainer.model) and not model.training
    assert modelzoo._validate_model(folder, device="cpu")
    rdf = bioimageio_spec.read_rdf(os.path.join(folder, "rdf.yaml"))
    entry = rdf["weights"]["pytorch_state_dict"]
    assert list(rdf["weights"]) == ["pytorch_state_dict"] and entry["source"] == "weights.pt"
    assert entry["architecture"]["callable"] == "UNet2d" and entry["architecture"]["import_from"] == "torch_em.model.unet"
    assert "device" not in entry["architecture"]["kwargs"] and "dtype" not in entry["architecture"]["kwargs"]
    assert np.load(os.path.join(folder, "test_output.npy")).dtype == np.float32


def test_port_package_passes_jax_validator(port_package):
    errors, warnings = jax_spec.validate_model_rdf(port_package[0])
    assert errors == [] and warnings == []
    assert bioimageio_spec.validate_model_rdf(port_package[0]) == (errors, warnings)


def test_broken_package_fails_validation(port_package, tmp_path):
    folder = shutil.copytree(port_package[0], tmp_path / "broken")
    np.save(folder / "test_output.npy", np.load(folder / "test_output.npy") + 1e-3)
    assert not modelzoo._validate_model(str(folder), device="cpu")


def test_torchscript_matches_state_dict_model(port_package, tmp_path):
    folder = shutil.copytree(port_package[0], tmp_path / "ts")
    modelzoo.add_weight_formats(str(folder), ["torchscript"])
    rdf = bioimageio_spec.read_rdf(str(folder / "rdf.yaml"))
    assert rdf["weights"]["torchscript"]["source"] == "weights_torchscript.pt"
    traced = torch.jit.load(str(folder / "weights_torchscript.pt"))
    model, _ = modelzoo.import_bioimageio_model(str(folder), device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).random((2, 1, 32, 32)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(traced(x).numpy(), model(x).numpy(), rtol=0, atol=OUTPUT_ATOL)
    assert jax_spec.validate_model_rdf(str(folder))[0] == []
    # the trace records cuDNN's TF32 flag (the last argument of each convolution): off, for float32 on a card
    convs = [n for n in traced.inlined_graph.nodes() if n.kind() == "aten::_convolution"]
    assert len(convs) == 13 and all(list(n.inputs())[-1].toIValue() is False for n in convs)


def test_onnx_raises_naming_onnx(port_package):
    with pytest.raises(ImportError, match="onnx"):
        modelzoo.add_weight_formats(port_package[0], ["onnx"])


def test_rdf_json_route_reads_alike_in_yaml(port_package):
    """Without PyYAML the rdf is JSON text; YAML 1.1 takes 1e-05 for a string, so its floats
    keep a dot and a signed exponent, and PyYAML reads the same values as json."""
    rdf = bioimageio_spec.read_rdf(os.path.join(port_package[0], "rdf.yaml"))
    assert rdf["config"]["tolerance"] == 1e-05
    text = bioimageio_spec.rdf_to_json_yaml(rdf)
    assert "1.0e-05" in text and yaml.safe_load(text) == json.loads(text) == rdf
    assert isinstance(yaml.safe_load(text)["config"]["tolerance"], float)


def test_rdf_without_yaml(port_package, tmp_path, monkeypatch):
    rdf = bioimageio_spec.read_rdf(os.path.join(port_package[0], "rdf.yaml"))
    monkeypatch.setitem(sys.modules, "yaml", None)
    bioimageio_spec.write_rdf(rdf, str(tmp_path / "rdf.yaml"))
    assert json.loads((tmp_path / "rdf.yaml").read_text()) == rdf
    assert bioimageio_spec.read_rdf(str(tmp_path / "rdf.yaml")) == rdf
    with pytest.raises(ImportError, match="PyYAML"):
        bioimageio_spec.read_rdf(os.path.join(port_package[0], "rdf.yaml"))


@pytest.mark.parametrize("spec", [
    None, {"name": "zero_mean_unit_variance", "kwargs": {"mode": "fixed", "mean": 0.5, "std": 2.0}},
    {"name": "scale_range", "kwargs": {"min_percentile": 0.0, "max_percentile": 100.0}},
    {"id": "scale_range", "kwargs": {"min_percentile": 2.0, "max_percentile": 98.0}},
])
def test_load_normalizer_matches_jax(spec):
    rdf = {"inputs": [{"preprocessing": [spec]} if spec else {}]}
    x = np.random.default_rng(6).normal(3.0, 2.0, (16, 16)).astype(np.float32)
    np.testing.assert_allclose(modelzoo._load_normalizer(rdf)(x), jax_modelzoo._load_normalizer(rdf)(x), atol=1e-6)


def test_tool_configs_match_jax(forest):
    offsets = [[-1, 0], [0, -1], [-3, 0]]
    assert modelzoo.get_mws_config(offsets, {"a": 1}) == jax_modelzoo.get_mws_config(offsets, {"a": 1})
    expected = jax_modelzoo.get_shallow2deep_config(forest[0])
    for path in (forest[0], forest[1], os.path.dirname(forest[1])):
        got = modelzoo.get_shallow2deep_config(path)
        assert got["shallow2deep"]["features"] == expected["shallow2deep"]["features"] == FILTER_CONFIG
        # the JAX package reads a forest attribute ``ndim`` that no forest has; the port reads feature_ndim
        assert expected["shallow2deep"]["ndim"] is None and got["shallow2deep"]["ndim"] == 2


def test_training_summary_matches_jax(jax_package):
    _, jax_trainer, paths = jax_package
    loader = port.default_segmentation_loader(paths[0], None, paths[1], None, batch_size=2, patch_shape=(1, 32, 32),
                                              ndim=2, n_samples=4)
    trainer = port.default_segmentation_trainer(
        "summary", port.UNet2d(1, 1, depth=2, initial_features=4, device="cpu"), loader, loader, device="cpu")
    got, expected = reporting.get_training_summary(trainer), jax_reporting.get_training_summary(jax_trainer)
    # the JAX trainer keeps its learning rate in float32
    assert np.float32(got.pop("learning_rate")) == np.float32(expected.pop("learning_rate"))
    assert got == expected
    markdown = reporting.get_training_summary(trainer, lr=1e-3, to_md=True)
    assert markdown == jax_reporting.get_training_summary(jax_trainer, lr=1e-3, to_md=True)


def test_export_cli(port_package, tmp_path, monkeypatch):
    folder, trainer = port_package
    np.save(tmp_path / "input.npy", np.random.default_rng(7).random((32, 32)).astype(np.float32))
    monkeypatch.setattr(sys, "argv", ["export", "-c", trainer.checkpoint_folder, "-i", str(tmp_path / "input.npy"),
                                      "-o", str(tmp_path / "cli"), "-d", "cpu"])
    modelzoo.main()
    monkeypatch.setattr(sys, "argv", ["convert", "-m", str(tmp_path / "cli"), "-w", "torchscript"])
    modelzoo.convert_main()
    rdf = bioimageio_spec.read_rdf(str(tmp_path / "cli" / "rdf.yaml"))
    assert sorted(rdf["weights"]) == ["pytorch_state_dict", "torchscript"]
    assert modelzoo._validate_model(str(tmp_path / "cli"), device="cpu")
