"""The rest of the port's ``utils/``: the medical readers and writers, their routing through
``utils/io.py``, the debug viewers, the SLURM template and ``predict_with_halo``'s progress
bar, on the CPU.

The medical readers are held bitwise against the JAX package's on files that either package
wrote; a ``SegmentationDataset`` over a NIfTI volume gives the JAX dataset's patches under
the same ``np.random`` seed.
"""

import os
import sys

import numpy as np
import pytest

from torch_em_tpu.data.segmentation_dataset import SegmentationDataset as JaxSegmentationDataset
from torch_em_tpu.utils import io as jax_io
from torch_em_tpu.utils import medical_io as jax_medical_io
import torch_em_tpu_torch as port
from torch_em_tpu_torch.utils import debug, io, medical_io, submit_slurm

FORMATS = {
    "nii": ("save_nifti", "load_nifti", {}),
    "nii.gz": ("save_nifti", "load_nifti", {}),
    "mha": ("save_mha", "load_mha", {"compressed": True}),
    "raw.mha": ("save_mha", "load_mha", {"compressed": False}),
    "nrrd": ("save_nrrd", "load_nrrd", {}),
    "mrc": ("save_mrc", "load_mrc", {}),
}


def _volume(dtype, seed=0):
    return (np.random.default_rng(seed).random((7, 9, 11)) * 200).astype(dtype)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_medical_io_matches_jax(fmt, writer, tmp_path):
    save, load, kwargs = FORMATS[fmt]
    path = str(tmp_path / f"volume.{fmt}")
    volume = _volume("int16" if fmt != "mrc" else "float32")
    getattr(jax_medical_io if writer == "jax" else medical_io, save)(path, volume, **kwargs)
    got, expected = getattr(medical_io, load)(path), getattr(jax_medical_io, load)(path)
    assert got.dtype == expected.dtype and got.shape == expected.shape == volume.shape
    assert np.array_equal(got, expected) and np.array_equal(got, volume)
    if writer == "port" and fmt != "nii.gz":  # gzip stamps the time into its header
        getattr(jax_medical_io, save)(str(tmp_path / f"jax.{fmt}"), volume, **kwargs)
        assert open(path, "rb").read() == open(str(tmp_path / f"jax.{fmt}"), "rb").read()


def test_nifti_affine_and_scaling_match_jax(tmp_path):
    path = str(tmp_path / "scaled.nii")
    affine = np.diag([0.5, 0.75, 2.0, 1.0])
    jax_medical_io.save_nifti(path, _volume("int16"), affine=affine)
    got, got_affine = medical_io.load_nifti(path, return_affine=True)
    expected, expected_affine = jax_medical_io.load_nifti(path, return_affine=True)
    assert np.array_equal(got, expected) and np.array_equal(got_affine, expected_affine)


@pytest.mark.parametrize("fmt", ["nii.gz", "mha", "mrc", "nrrd"])
def test_load_data_routes_medical_formats_as_jax(fmt, tmp_path):
    save = FORMATS[fmt][0]
    path = str(tmp_path / f"volume.{fmt}")
    getattr(medical_io, save)(path, _volume("float32"))
    got, expected = io.load_data(path), jax_io.load_data(path)
    assert np.array_equal(np.asarray(got), np.asarray(expected))
    if fmt in ("nii.gz", "mha"):  # load_image reads these two, as the JAX package's does
        assert np.array_equal(io.load_image(path), jax_io.load_image(path))
    with pytest.raises(NotImplementedError, match="medical_io"):
        io.write_data(path, None, _volume("float32"))


def test_segmentation_dataset_over_nifti_matches_jax(tmp_path):
    raw, labels = str(tmp_path / "raw.nii.gz"), str(tmp_path / "labels.nii.gz")
    medical_io.save_nifti(raw, _volume("float32"))
    medical_io.save_nifti(labels, _volume("uint8", seed=1) // 50)
    kwargs = dict(patch_shape=(4, 8, 8), n_samples=3)
    port_ds = port.SegmentationDataset(raw, None, labels, None, **kwargs)
    jax_ds = JaxSegmentationDataset(raw, None, labels, None, **kwargs)
    for i in range(3):
        np.random.seed(i)
        expected = jax_ds[i]
        np.random.seed(i)
        got = port_ds[i]
        assert all(np.array_equal(g, e) for g, e in zip(got, expected)) and got[0].shape == (1, 4, 8, 8)


def _trainer(tmp_path):
    rng = np.random.default_rng(0)
    raw, labels = rng.random((2, 32, 32)).astype(np.float32), (rng.random((2, 32, 32)) > 0.5).astype(np.float32)
    ds = port.SegmentationDataset(raw, None, labels, None, patch_shape=(1, 16, 16), ndim=2, n_samples=2)
    loader = port.DataLoader(ds, batch_size=1)
    model = port.UNet2d(1, 1, depth=2, initial_features=4, device="cpu")
    return port.default_segmentation_trainer("dbg", model, loader, loader, device="cpu", save_root=str(tmp_path))


def test_check_loader_and_trainer(tmp_path):
    trainer = _trainer(tmp_path)
    paths = debug.check_loader(trainer.train_loader, n_samples=2, save_path=str(tmp_path / "loader"))
    assert paths == [str(tmp_path / f"loader_sample{i}.png") for i in range(2)]
    paths = debug.check_trainer(trainer, n_samples=1, instance_labels=True, save_path=str(tmp_path / "trainer"))
    assert len(paths) == 1 and all(os.path.getsize(p) > 0 for p in paths)


def test_slurm_template_runs_the_port(tmp_path):
    out = str(tmp_path / "job.sh")
    submit_slurm.write_slurm_template("train.py", out, None, 8, "32G", "1:00:00", "normal", exclude_nodes=["a", "b"])
    text = open(out).read()
    assert text.startswith("#!/bin/bash\n") and "#SBATCH --gres=gpu:1" in text and "#SBATCH -c 8" in text
    assert "#SBATCH --exclude=a,b" in text and "source activate" not in text and "jax" not in text.lower()
    assert text.rstrip().endswith(f"{sys.executable} train.py $@")
    submit_slurm.write_slurm_template("train.py", out, "env", 8, "32G", "1:00:00", "normal")
    assert "source activate env\n\npython train.py $@" in open(out).read()


def test_submit_slurm_calls_sbatch_with_the_template(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(submit_slurm.subprocess, "run", lambda cmd, check: calls.append(cmd))
    kwargs, rest = submit_slurm.scrape_kwargs(["--n_threads", "4", "-x", "1", "--qos", "long"])
    assert kwargs == {"n_threads": "4", "qos": "long"} and rest == ["-x", "1"]
    script = submit_slurm.submit_slurm("train.py", rest, tmp_folder=str(tmp_path), **kwargs)
    assert calls and calls[0][0] == "sbatch" and calls[0][-3:] == [script, "-x", "1"]
    assert "#SBATCH -c 4" in open(script).read()


@pytest.mark.parametrize("tqdm_installed", [True, False])
def test_predict_with_halo_progress_bar(tqdm_installed, capsys, monkeypatch):
    if not tqdm_installed:
        monkeypatch.setitem(sys.modules, "tqdm", None)
    model = port.UNet2d(1, 1, depth=2, initial_features=4, device="cpu")
    volume = np.random.default_rng(0).random((40, 40)).astype(np.float32)
    out = port.predict_with_halo(volume, model, block_shape=(16, 16), halo=(4, 4), tqdm_desc="halo blocks")
    quiet = port.predict_with_halo(volume, model, block_shape=(16, 16), halo=(4, 4), disable_tqdm=True)
    assert np.array_equal(out, quiet)
    err = capsys.readouterr().err
    assert ("halo blocks" in err and "9/9" in err) == tqdm_installed
