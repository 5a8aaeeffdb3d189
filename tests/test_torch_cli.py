"""The port's command line entry points, run in subprocesses on the CPU (``--device cpu``).

Training writes a checkpoint; prediction through the CLI equals the port's
own ``predict_with_padding``, ``predict_with_halo`` and model call on the
model rebuilt from that checkpoint (those functions are held against the
JAX package in ``test_torch_prediction.py`` and
``test_torch_prediction_paths.py``), and, with a JAX model's weights carried
into the checkpoint, the JAX package's ``predict_with_padding`` to 1e-4.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from torch_em_tpu.models import UNet2d as JaxUNet2d
from torch_em_tpu.transforms.raw import standardize as jax_standardize
from torch_em_tpu.utils.prediction import predict_with_padding as jax_predict_with_padding
from torch_em_tpu_torch import cli, predict_with_halo, predict_with_padding, standardize, state_dict_from_jax_params
from torch_em_tpu_torch.utils import get_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(entry, args, cwd):
    code = f"import sys; sys.argv = [{entry!r}] + {args!r}\nfrom torch_em_tpu_torch.cli import {entry}\n{entry}()\n"
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def trained_2d(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli2d")
    rng = np.random.default_rng(0)
    for sub in ("images", "masks"):
        os.makedirs(root / sub)
    for i in range(5):
        h, w = rng.integers(36, 60, 2)
        np.save(root / "images" / f"{i}.npy", rng.random((h, w)).astype(np.float32))
        np.save(root / "masks" / f"{i}.npy", rng.integers(0, 4, (h, w)).astype(np.uint16))
    _run("train_2d_unet", ["-i", str(root / "images"), "-l", str(root / "masks"), "-k", "*.npy",
                           "--training_label_key", "*.npy", "-b", "2", "-p", "1", "32", "32", "-n", "2",
                           "-m", "boundaries_and_foreground", "--name", "cli-2d", "-d", "cpu"], cwd=str(root))
    return root, str(root / "checkpoints" / "cli-2d")


@pytest.fixture(scope="module")
def trained_3d(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli3d")
    rng = np.random.default_rng(1)
    path = str(root / "data.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("raw", data=rng.random((8, 64, 64)).astype(np.float32))
        f.create_dataset("labels", data=rng.integers(0, 3, (8, 64, 64)).astype(np.uint32))
    _run("train_3d_unet", ["-i", path, "-l", path, "-k", "raw", "--training_label_key", "labels", "-b", "1",
                           "-p", "8", "32", "32", "-n", "2", "-m", "affinities", "-s", "[[1,2,2],[2,2,2]]",
                           "--name", "cli-3d", "-d", "cpu"], cwd=str(root))
    return root, str(root / "checkpoints" / "cli-3d")


def test_train_2d_unet_writes_a_checkpoint(trained_2d):
    _, folder = trained_2d
    trainer = get_trainer(folder, name="latest", device="cpu")
    assert trainer.iteration == 2 and trainer.device.type == "cpu"
    assert trainer.model.init_kwargs["in_channels"] == 1 and trainer.model.init_kwargs["out_channels"] == 2
    assert type(trainer.train_loader.dataset).__name__ == "_Subset"


def test_train_3d_unet_writes_a_checkpoint(trained_3d):
    _, folder = trained_3d
    trainer = get_trainer(folder, name="latest", device="cpu")
    assert trainer.iteration == 2
    assert trainer.model.init_kwargs["scale_factors"] == [[1, 2, 2], [2, 2, 2]]
    assert trainer.model.init_kwargs["out_channels"] == 12  # the 3D affinity offsets, without their masks
    assert type(trainer.loss).__name__ == "LossWrapper"


def test_predict_matches_predict_with_padding(trained_2d):
    root, folder = trained_2d
    image = np.random.default_rng(2).random((50, 70)).astype(np.float32)
    np.save(root / "predict_input.npy", image)
    _run("predict", ["-c", folder, "-i", str(root / "predict_input.npy"), "-o", str(root / "pred.npy"),
                     "--output_key", "pred", "--min_divisible", "16", "16", "-d", "cpu"], cwd=str(root))
    model = get_trainer(folder, device="cpu").model
    expected = predict_with_padding(model, standardize(image), (16, 16), "cpu").squeeze()
    np.testing.assert_allclose(np.load(root / "pred.npy"), expected, rtol=0, atol=1e-6)


def test_predict_matches_jax_on_carried_weights(trained_2d, tmp_path):
    """A JAX UNet2d's weights written into the CLI's checkpoint: ``predict`` gives the JAX
    package's ``predict_with_padding`` on the same weights."""
    root, folder = trained_2d
    jax_model = JaxUNet2d(1, 2, seed=3)
    params = {k: np.asarray(v) for k, v in flatten_dict(jax_model.variables["params"], sep="/").items()}
    save_dict = torch.load(os.path.join(folder, "latest.ckpt"), weights_only=True)
    save_dict["model_state"] = state_dict_from_jax_params(params)
    carried = tmp_path / "carried"
    carried.mkdir()
    torch.save(save_dict, carried / "best.ckpt")
    image = np.random.default_rng(6).random((40, 56)).astype(np.float32)
    np.save(tmp_path / "input.npy", image)
    _run("predict", ["-c", str(carried), "-i", str(tmp_path / "input.npy"), "-o", str(tmp_path / "pred.npy"),
                     "--output_key", "pred", "--min_divisible", "16", "16", "-d", "cpu"], cwd=str(root))
    expected = np.asarray(jax_predict_with_padding(jax_model, jax_standardize(image), (16, 16))).squeeze()
    np.testing.assert_allclose(np.load(tmp_path / "pred.npy"), expected, rtol=0, atol=1e-4)


def test_predict_without_padding_calls_the_model(trained_2d):
    root, folder = trained_2d
    image = np.random.default_rng(3).random((32, 48)).astype(np.float32)
    np.save(root / "plain_input.npy", image)
    _run("predict", ["-c", folder, "-i", str(root / "plain_input.npy"), "-o", str(root / "plain.npy"),
                     "--output_key", "pred", "-d", "cpu"], cwd=str(root))
    model = get_trainer(folder, device="cpu").model
    with torch.inference_mode():
        expected = model(torch.from_numpy(standardize(image)[None, None])).numpy().squeeze()
    np.testing.assert_allclose(np.load(root / "plain.npy"), expected, rtol=0, atol=1e-6)


def test_predict_with_tiling_matches_predict_with_halo_3d(trained_3d):
    root, folder = trained_3d
    volume = np.random.default_rng(4).random((8, 48, 40)).astype(np.float32)
    with h5py.File(root / "input.h5", "w") as f:
        f.create_dataset("raw", data=volume)
    _run("predict_with_tiling", ["-c", folder, "-i", str(root / "input.h5"), "-k", "raw", "-o",
                                 str(root / "pred.h5"), "--output_key", "pred", "-b", "8", "32", "32",
                                 "--halo", "0", "8", "8", "-d", "cpu"], cwd=str(root))
    model = get_trainer(folder, device="cpu").model
    expected = predict_with_halo(volume, model, gpu_ids=["cpu"], block_shape=[8, 32, 32], halo=[0, 8, 8])
    with h5py.File(root / "pred.h5", "r") as f:
        got = f["pred"][:]
    assert got.shape == (12, 8, 48, 40)
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-6)


def test_predict_with_tiling_2d_blocks_of_a_stack(trained_2d):
    """Blocks of shape (1, y, x) run the 2D model on each plane (``_pred_2d``)."""
    root, folder = trained_2d
    volume = np.random.default_rng(5).random((2, 40, 36)).astype(np.float32)
    np.save(root / "stack.npy", volume)
    _run("predict_with_tiling", ["-c", folder, "-i", str(root / "stack.npy"), "-o", str(root / "stack_pred.npy"),
                                 "--output_key", "pred", "-b", "1", "32", "32", "--halo", "0", "8", "8",
                                 "-d", "cpu"], cwd=str(root))
    model = get_trainer(folder, device="cpu").model
    expected = predict_with_halo(volume, model, gpu_ids=["cpu"], block_shape=[1, 32, 32], halo=[0, 8, 8],
                                 prediction_function=cli._pred_2d)
    np.testing.assert_allclose(np.load(root / "stack_pred.npy"), expected, rtol=0, atol=1e-6)


def test_cli_defaults_to_the_card():
    for parser in (cli._get_training_parser("t"), ):
        args = parser.parse_args(["-i", "x", "-l", "y", "-b", "1", "-p", "1", "2"])
        assert args.device == "cuda"
    assert cli._get_offsets(2, None)[-1] == [0, -27]
    assert len(cli._get_offsets(3, [[1, 2, 2]])) == 12
    assert type(cli._get_loss("affinities")).__name__ == "LossWrapper"
    assert type(cli._get_loss(None)).__name__ == "DiceLoss"
