"""The quality-point probe ``scripts/torch_parity3d.py`` on the CPU.

- Its data: the port's ``make_volume`` regenerates the tracked probe volumes
  of ``experiments/parity/parity_data3d`` from seed 13: labels equal, raw
  within 1e-6, and the labels' sha256 that the script prints equals that of
  the HDF5 files.
- Its yardsticks equal ``experiments/parity``'s records, and its Welch t
  reproduces the one recorded there for the JAX package against torch-em.
- Both modes run end to end for 4 iterations on the CPU.
- The tracked scale: the port's ``make_volume`` at (40, 320, 320) from seed 13 gives the
  first train volume of ``experiments/parity/make_data3d.py``'s generator (the tracked-scale
  files are not in the tree), its yardsticks are ``parity_out3d_tracked``'s records, and it
  runs end to end for 2 iterations at a narrowed width, volume and patch.
"""

import importlib.util
import json
import os
from glob import glob

import h5py
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(REPO, "experiments", "parity")


def _probe():
    spec = importlib.util.spec_from_file_location("torch_parity3d", os.path.join(REPO, "scripts", "torch_parity3d.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


probe = _probe()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel workers; torch's thread pool in each would oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_regenerated_volumes_equal_the_tracked_files(tmp_path, capsys):
    paths = probe.make_data(str(tmp_path))
    printed = capsys.readouterr().out
    for split in ("train", "val"):
        tracked = sorted(glob(os.path.join(PARITY, "parity_data3d", split, "vol*.h5")))
        assert len(tracked) == len(paths[split]) == {"train": 6, "val": 2}[split]
        for h5_path, (raw_path, labels_path, boundaries_path) in zip(tracked, paths[split]):
            with h5py.File(h5_path, "r") as f:
                raw, labels = f["raw"][:], f["labels"][:]
            np.testing.assert_array_equal(np.load(labels_path), labels)
            np.testing.assert_allclose(np.load(raw_path), raw, rtol=0, atol=1e-6)
            assert probe.labels_digest(labels) in printed
            boundaries = np.load(boundaries_path)
            assert boundaries.shape == labels.shape and 0 < boundaries.mean() < 1


def test_yardsticks_match_the_records():
    with open(os.path.join(PARITY, "parity_r5_summary.json")) as f:
        record = json.load(f)["cremi3d_free_seeds_r5"]
    assert probe.JAX_BOUNDARY_DICE == list(record["tpu"]["by_seed"].values())
    assert probe.REFERENCE_BOUNDARY_DICE == list(record["reference"]["by_seed"].values())
    t, dof = probe.welch(probe.JAX_BOUNDARY_DICE, probe.REFERENCE_BOUNDARY_DICE)
    assert round(t, 3) == record["welch_t"] and round(dof, 1) == record["welch_dof"]
    for side, values in (("tpu", probe.JAX_BOUNDARY_DICE), ("reference", probe.REFERENCE_BOUNDARY_DICE)):
        stats = probe.distribution(values)
        assert round(stats["mean"], 4) == record[side]["mean"] and round(stats["std"], 4) == record[side]["std"]
    with open(os.path.join(PARITY, "parity_out_affinity", "affinity_mws_results.json")) as f:
        affinity = json.load(f)
    assert probe.JAX_AFFINITY == {"mean_voi": affinity["mean_voi"], "mean_f1": affinity["mean_f1"]}
    assert probe.ITERATIONS["affinity"] == affinity["iterations"]
    with open(os.path.join(PARITY, "parity_out3d_tracked", "parity_table3d.json")) as f:
        tracked = json.load(f)
    assert probe.JAX_TRACKED_DICE == tracked["torch_em_tpu"]["dice_boundary"]
    assert probe.REFERENCE_TRACKED_DICE == tracked["reference-torch"]["dice_boundary"]
    with open(os.path.join(PARITY, "parity_out3d_tracked", "tpu_result3d.json")) as f:
        assert probe.TRACKED_ITERATIONS == json.load(f)["iterations"]


def test_tracked_volume_equals_the_jax_generator():
    """``make_data3d.py --shape 40,320,320 --seed 13``'s first train volume: labels bitwise, raw within 1e-6."""
    from torch_em_tpu_torch.utils.test import make_volume

    spec = importlib.util.spec_from_file_location("make_data3d", os.path.join(PARITY, "make_data3d.py"))
    make_data3d = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_data3d)
    raw, labels = make_volume(np.random.default_rng(probe.DATA_SEED), probe.TRACKED_VOLUME)
    expected_raw, expected_labels = make_data3d.make_volume(np.random.default_rng(13), (40, 320, 320))
    assert labels.shape == probe.TRACKED_VOLUME and labels.dtype == expected_labels.dtype
    np.testing.assert_array_equal(labels, expected_labels)
    np.testing.assert_allclose(raw, expected_raw, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["boundary", "affinity"])
def test_probe_runs_on_the_cpu(mode, tmp_path):
    assert probe.main(["--mode", mode, "--seeds", "0", "1", "-n", "4", "-d", "cpu", "-o", str(tmp_path)]) == 0
    with open(tmp_path / f"{mode}_results.json") as f:
        result = json.load(f)
    assert [r["seed"] for r in result["runs"]] == [0, 1] and all(r["iterations"] == 4 for r in result["runs"])
    summary = result["summary"]
    if mode == "boundary":
        assert all(0 < r["dice_boundary"] < 1 for r in result["runs"])
        assert summary["port"]["n"] == 2 and np.isfinite(summary["vs_jax"]["welch_t"])
    else:
        for run in result["runs"]:
            assert len(run["per_volume"]) == 2 and np.isfinite(run["mean_voi"]) and 0 <= run["mean_f1"] <= 1
            assert all(v["n_pred_instances"] > 0 for v in run["per_volume"])
        assert summary["vs_jax_cpu"]["mean_voi"]["port"]["n"] == 2 and "one_sample_t" in summary["vs_jax_tpu_run"]["mean_f1"]


def test_tracked_scale_runs_on_the_cpu(tmp_path, monkeypatch):
    """The tracked boundary run with the device label transform, at 4 features on 12x64x64 volumes and
    8x32x32 patches, for 2 iterations per seed."""
    monkeypatch.setattr(probe, "TRACKED_VOLUME", (12, 64, 64))
    monkeypatch.setattr(probe, "TRACKED_PATCH", (8, 32, 32))
    monkeypatch.setattr(probe, "TRACKED_MODEL", dict(probe.TRACKED_MODEL, initial_features=4))
    args = ["--mode", "boundary", "--scale", "tracked", "--seeds", "0", "1", "-n", "2", "-d", "cpu"]
    assert probe.main(args + ["-o", str(tmp_path)]) == 0
    with open(tmp_path / "boundary_tracked_results.json") as f:
        result = json.load(f)
    assert len(os.listdir(tmp_path / "data" / "train")) == 3 * probe.TRACKED_N_TRAIN
    for run in result["runs"]:
        assert run["iterations"] == 2 and 0 < run["dice_boundary"] < 1
        assert len(run["curves"]["val_metric"]) == len(run["curves"]["train_loss"]) == 1
    summary = result["summary"]
    assert summary["port"]["n"] == 2 and summary["vs_reference"]["reference_n1"] == 0.9838
    assert summary["hit"]["yardstick"] == 0.9847 and "one_sample_t" in summary["vs_jax"]
    assert result["backend"]["cudnn.deterministic"] is False
    with pytest.raises(SystemExit):
        probe.main(["--mode", "affinity", "--scale", "tracked", "--seeds", "0", "-o", str(tmp_path)])


def test_affinity_validation_patches_match_jax(tmp_path):
    """ROADMAP Queue 3 item 7, first suspect: the affinity probe's validation patches. With the
    same ``np.random`` state, the port's val loader draws the same 8 crops with the same targets
    as ``train_affinity3d.py``'s over the tracked files, and both draw new ones at every
    validation. The default flips are left out of the comparison: each package draws them from
    its own pipeline's generator (their application on shared parameters is held in
    ``tests/test_torch_augmentation.py``)."""
    import torch_em_tpu as te
    from torch_em_tpu.transforms.label import AffinityTransform as JaxAffinityTransform

    paths = probe.make_data(str(tmp_path))
    tracked = sorted(glob(os.path.join(PARITY, "parity_data3d", "val", "vol*.h5")))
    jax_loader = te.default_segmentation_loader(
        tracked, "raw", tracked, "labels", batch_size=1, patch_shape=probe.PATCH, ndim=3, label_dtype="float32",
        label_transform2=JaxAffinityTransform(offsets=probe.AFFINITY_OFFSETS, add_binary_target=True,
                                              add_mask=True), n_samples=8)
    loader = probe.affinity_loader(paths["val"], 8)
    for ds in jax_loader.dataset.datasets + loader.dataset.datasets:
        assert type(ds.transform).__name__ == "AugmentationPipeline"
        ds.transform = None
    epochs = []
    for epoch in range(2):
        np.random.seed(100 + epoch)
        expected = [(np.asarray(x), np.asarray(y)) for x, y in jax_loader]
        np.random.seed(100 + epoch)
        got = [(x.numpy(), y.numpy()) for x, y in loader]
        assert len(got) == len(expected) == 8
        for (x, y), (ex, ey) in zip(got, expected):
            np.testing.assert_array_equal(y, ey)
            # raw regenerated within 1e-6 of the files, then standardized per patch
            np.testing.assert_allclose(x, ex, rtol=0, atol=1e-4)
        epochs.append(got)
    assert not any(np.array_equal(a[1], b[1]) for a, b in zip(*epochs))


def test_best_checkpoint_choice_matches_jax(tmp_path):
    """ROADMAP Queue 3 item 7, second suspect: which checkpoint counts as best. Both trainers,
    fed the same sequence of validation metrics (ties and a later minimum included), keep the
    same epoch as best, and ``load_checkpoint("best")`` restores the same iteration."""
    import jax  # noqa: F401
    import torch_em_tpu as te
    from torch_em_tpu.data.loader import DataLoader as JaxDataLoader
    from torch_em_tpu.data.segmentation_dataset import SegmentationDataset as JaxSegmentationDataset
    from torch_em_tpu.models.unet import AnisotropicUNet as JaxAnisotropicUNet

    import torch_em_tpu_torch as port

    metrics = [0.5, 0.4, 0.45, 0.4, 0.3, 0.35, 0.3]
    raw = np.random.default_rng(0).normal(size=(8, 32, 32)).astype(np.float32)
    labels = (raw > 0).astype(np.float32)
    model_kwargs = dict(in_channels=1, out_channels=1, scale_factors=[[1, 2, 2]], initial_features=2,
                        final_activation="Sigmoid")
    results = []
    for side in ("jax", "port"):
        if side == "jax":
            ds = JaxSegmentationDataset(raw, None, labels, None, patch_shape=(4, 16, 16), n_samples=1)
            trainer = te.default_segmentation_trainer(
                "best", JaxAnisotropicUNet(**model_kwargs), JaxDataLoader(ds), JaxDataLoader(ds), device="cpu",
                mixed_precision=False, logger=None, save_root=str(tmp_path / side))
        else:
            ds = port.SegmentationDataset(raw, None, labels, None, patch_shape=(4, 16, 16), n_samples=1)
            trainer = port.default_segmentation_trainer(
                "best", port.AnisotropicUNet(**model_kwargs, device="cpu"), port.DataLoader(ds), port.DataLoader(ds),
                device="cpu", mixed_precision=False, logger=None, save_root=str(tmp_path / side))
        scripted = iter(metrics)
        trainer._validate = lambda: next(scripted)
        trainer.fit(iterations=len(metrics))
        best_epoch = trainer._best_epoch
        trainer.load_checkpoint("best")
        results.append((best_epoch, trainer.iteration, trainer.best_metric))
    assert results[0] == results[1] == (4, 5, 0.3)
