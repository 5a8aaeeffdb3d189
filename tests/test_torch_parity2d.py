"""The DSB quality-point probe ``scripts/torch_parity2d.py`` on the CPU.

- Its data: the port's ``make_image`` regenerates ``experiments/parity/parity_data`` from
  seed 42 (labels equal, raw within 1e-6 of the HDF5 files) and the first train images of
  ``parity_data256``; the script's sha256 constants are those of the files' labels.
- Its dataset over the ``.npy`` files gives the samples of a ``TensorDataset`` over the same
  arrays, ``experiments/parity/train_tpu.py``'s dataset.
- Its ``dice_per_channel`` is ``experiments/parity/evaluate.py``'s, and its yardsticks are the
  records of ``experiments/parity/parity_out_s{0,1,2}`` and ``parity_out_tracked``.
- Both scales run end to end on the CPU: the probe for 4 iterations, the tracked scale for 2
  at a narrowed width and batch on its first images.
"""

import functools
import importlib.util
import json
import os

import h5py
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(REPO, "experiments", "parity")
FOLDERS = {"probe": "parity_data", "tracked": "parity_data256"}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


probe = _load("torch_parity2d", os.path.join(REPO, "scripts", "torch_parity2d.py"))


def _tracked(scale, split, n=None):
    with h5py.File(os.path.join(PARITY, FOLDERS[scale], f"{split}.h5"), "r") as f:
        return f["raw"][:n], f["labels"][:n]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel workers; torch's thread pool in each would oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _check_regenerated(paths, scale, split, n=None):
    raw, labels = _tracked(scale, split, n)
    raw_paths, label_paths = paths[split]
    assert len(raw_paths) == len(label_paths) == len(labels)
    for i, (raw_path, label_path) in enumerate(zip(raw_paths, label_paths)):
        np.testing.assert_array_equal(np.load(label_path), labels[i])
        np.testing.assert_allclose(np.load(raw_path), raw[i], rtol=0, atol=1e-6)


def test_regenerated_probe_images_equal_the_tracked_files(tmp_path, capsys):
    paths = probe.make_data(str(tmp_path), "probe")
    printed = capsys.readouterr().out
    for split in ("train", "val"):
        _check_regenerated(paths, "probe", split)
        assert probe.LABELS_SHA256["probe"][split] in printed


def test_regenerated_tracked_images_equal_the_first_tracked_files(tmp_path):
    paths = probe.make_data(str(tmp_path), "tracked", n_train=16, n_val=0)
    assert paths["val"] == ([], [])
    _check_regenerated(paths, "tracked", "train", 16)


@pytest.mark.parametrize("scale", ["probe", "tracked"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_digests_are_the_tracked_labels(scale, split):
    _, labels = _tracked(scale, split)
    assert labels.dtype == np.uint32 and labels.shape[1:] == (probe.SCALES[scale]["size"],) * 2
    assert probe.labels_digest(labels) == probe.LABELS_SHA256[scale][split]


def test_dataset_over_files_gives_the_tensor_dataset_samples(tmp_path):
    """The script's ``ImageCollectionDataset`` of the ``.npy`` files against ``train_tpu.py``'s
    ``TensorDataset`` of the arrays, both with the boundary targets and the whole image as patch."""
    from torch_em_tpu_torch.data import ImageCollectionDataset, TensorDataset

    paths = probe.make_data(str(tmp_path), "probe", n_train=6, n_val=0)
    raws, labels = ([np.load(p) for p in files] for files in paths["train"])
    kwargs = dict(patch_shape=(128, 128), label_transform=probe.boundary_targets(), label_dtype="float32")
    arrays, files = TensorDataset(raws, labels, **kwargs), ImageCollectionDataset(*paths["train"], **kwargs)
    assert len(arrays) == len(files) == 6
    for i in range(6):
        (x, y), (ex, ey) = files[i], arrays[i]
        assert x.shape == (1, 128, 128) and y.shape == (2, 128, 128)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(ex))
        np.testing.assert_array_equal(np.asarray(y), np.asarray(ey))


def test_dice_per_channel_is_the_evaluators():
    evaluate = _load("parity_evaluate", os.path.join(PARITY, "evaluate.py"))
    rng = np.random.default_rng(0)
    pred = rng.random((5, 2, 32, 48), dtype=np.float32)
    target = (rng.random((5, 2, 32, 48)) > 0.7).astype("float32")
    np.testing.assert_array_equal(probe.dice_per_channel(pred, target), evaluate.dice_per_channel(pred, target))
    np.testing.assert_array_equal(probe.dice_per_channel(np.zeros_like(pred), np.zeros_like(target)),
                                  evaluate.dice_per_channel(np.zeros_like(pred), np.zeros_like(target)))


def test_yardsticks_match_the_records():
    torch_em, jax = [], []
    for seed in range(3):
        with open(os.path.join(PARITY, f"parity_out_s{seed}", "parity_table.json")) as f:
            table = json.load(f)
        torch_em.append(table["reference-torch"]["dice_mean"])
        jax.append(table["torch_em_tpu"]["dice_mean"])
    assert probe.TORCH_EM_PROBE_DICE == torch_em and probe.JAX_PROBE_DICE == jax
    with open(os.path.join(PARITY, "parity_out_tracked", "parity_table.json")) as f:
        assert probe.JAX_TRACKED_DICE == json.load(f)["torch_em_tpu"]
    with open(os.path.join(PARITY, "parity_out_tracked", "tpu_result.json")) as f:
        assert probe.SCALES["tracked"]["iterations"] == json.load(f)["iterations"]
    with open(os.path.join(PARITY, "parity_out_s0", "tpu_result.json")) as f:
        assert probe.SCALES["probe"]["iterations"] == json.load(f)["iterations"]


def _check_result(path, seeds, iterations):
    with open(path) as f:
        result = json.load(f)
    assert [r["seed"] for r in result["runs"]] == seeds and result["iterations"] == iterations
    for run in result["runs"]:
        assert run["iterations"] == iterations and 0 < run["best_checkpoint_iteration"] <= iterations
        assert all(0 <= run[k] <= 1 for k in ("dice_foreground", "dice_boundary", "dice_mean"))
        curves = run["curves"]
        assert len(curves["val_metric"]) == len(curves["train_loss"]) == len(curves["lr"]) >= 1
        assert np.all(np.isfinite(curves["train_loss"]))
    assert set(result["backend"]) >= {"cudnn.allow_tf32", "cuda.matmul.allow_tf32", "cudnn.deterministic"}
    return result["summary"]


def test_probe_runs_on_the_cpu(tmp_path):
    assert probe.main(["--scale", "probe", "--seeds", "0", "1", "-n", "4", "-d", "cpu", "-o", str(tmp_path)]) == 0
    summary = _check_result(tmp_path / "dsb_probe_results.json", [0, 1], 4)
    assert summary["dice_mean"]["n"] == 2 and np.isfinite(summary["vs_torch_em"]["welch_t"])
    assert summary["hit"]["yardstick"] == pytest.approx(np.mean(probe.TORCH_EM_PROBE_DICE))
    assert summary["hit"]["hit"] is False  # four iterations are far from the recipe's Dice


def test_tracked_scale_runs_on_the_cpu(tmp_path, monkeypatch):
    """The tracked scale at 4 features and batch 2, on its first 8 train and 4 val images."""
    monkeypatch.setitem(probe.SCALES, "tracked", dict(probe.SCALES["tracked"], features=4, batch_size=2))
    monkeypatch.setattr(probe, "make_data", functools.partial(probe.make_data, n_train=8, n_val=4))
    assert probe.main(["--scale", "tracked", "--seeds", "0", "1", "-n", "2", "-d", "cpu", "-o", str(tmp_path)]) == 0
    summary = _check_result(tmp_path / "dsb_tracked_results.json", [0, 1], 2)
    assert summary["vs_jax"]["jax_n1"]["dice_mean"] == 0.9919 and "one_sample_t" in summary["vs_jax"]
    assert summary["hit"]["yardstick"] == 0.9919
    assert len(np.load(os.path.join(tmp_path, "data", "train", "raw_000.npy"))) == 256
