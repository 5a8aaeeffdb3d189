"""The port's quality points: the 3D parity probes of ``experiments/parity``, run with the port.

    python3 scripts/torch_parity3d.py --mode boundary --seeds 0 1 2 3 4 5 6 7 -o OUT
    python3 scripts/torch_parity3d.py --mode boundary --scale tracked --seeds 0 1 2 -o OUT
    python3 scripts/torch_parity3d.py --mode affinity --seeds 0 1 2 3 4 5 --deterministic -o OUT
    python3 scripts/torch_parity3d.py --mode boundary --seeds 0 --iterations 4 --device cpu -o OUT

Imports only the port (``torch_em_tpu_torch``) and ``chip_smoke`` (for the
card's name and power limit), and runs on the card unless ``--device
cpu``. Steps:

1. Data: regenerates the probe volumes of ``experiments/parity/make_data3d.py``
   (seed 13, 6 train and 2 val volumes of 24x96x96; ``--scale tracked``: 4
   train and 2 val volumes of 40x320x320, ``--shape 40,320,320 --n-train 4
   --n-val 2``) with the port's ``utils.test.make_volume`` into ``OUT/data``
   as ``.npy`` and prints a sha256 of each labels volume (uint32, C order),
   which ``tests/test_torch_parity3d.py`` takes from the HDF5 files of
   ``experiments/parity/parity_data3d`` (the tracked-scale volumes are not in
   the tree: the test holds the first against ``make_data3d.py``'s generator).
2. ``--mode boundary``, the CREMI-style "pb" protocol of
   ``experiments/parity/run_r5_tpu_seeds.sh`` (``train_tpu3d.py --fixed-val
   --precomputed-boundaries``): ``BoundaryTransform(mode="thick", ndim=3)``
   targets computed on the full volumes, a fixed val ROI (0:8, 0:64, 0:64) per
   val volume, ``AnisotropicUNet(scale_factors=[[1,2,2],[2,2,2]],
   initial_features=8, Sigmoid)``, AdamW (lr 1e-4, weight decay 0.01), the
   default plateau scheduler, mixed precision, patches (8, 64, 64) at batch 1,
   ``n_samples=50`` per epoch, 1500 iterations; the score is the soft boundary
   Dice of the best checkpoint's predictions on the val crops
   (``experiments/parity/evaluate3d.py:soft_dice``). The summary sets the
   seeds' mean and std beside the 16-seed distributions of
   ``experiments/parity/parity_r5_summary.json`` (JAX package and
   reference torch-em), with each mean gap and Welch's t.
   ``--scale tracked``, the tracked CREMI run of
   ``experiments/parity/run_r3_all.sh`` (``train_tpu3d.py --device-transform
   --patch 32,256,256 --features 32 --tracked-model``): the tracked
   ``AnisotropicUNet(scale_factors=[[1,2,2],[1,2,2],[2,2,2],[2,2,2]],
   initial_features=32, anisotropic_kernel=True, Sigmoid)``, raw labels to
   the card and ``DeviceBoundaryTransform(ndim=3)`` as the trainer's device
   label transform, patches (32, 256, 256) at batch 1 with the loader's
   default augmentations, validation on 8 random patches, 1000 iterations
   (what ``parity_out3d_tracked/tpu_result3d.json`` records); the score is the
   soft boundary Dice of the best checkpoint's predictions of each val
   volume's (0:32, 0:256, 0:256) crop against host
   ``BoundaryTransform(mode="thick", ndim=3)`` targets of the whole volume,
   cropped the same way (``train_tpu3d.py``, ``evaluate3d.py --patch
   32,256,256``). The summary sets the seeds' mean beside the JAX package's
   one run (0.9847, ``parity_out3d_tracked/parity_table3d.json``), with the
   gap and the one-sample t, and beside the reference's 0.9838 (torch-em
   trained 800 iterations on 16x128x128 patches, scored at 32x256x256).
   A tracked point is a hit when the seeds' mean lies within 1% of JAX's.
   Both scales record each seed's training loss, learning rate and
   validation metric per epoch through a logger that changes no step.
3. ``--mode affinity``, the SNEMI-style probe of
   ``experiments/parity/train_affinity3d.py``: six offsets through
   ``AffinityTransform(add_binary_target=True, add_mask=True)``, masked Dice
   (``LossWrapper(DiceLoss(), ApplyAndRemoveMask())``) as loss and metric,
   f=8, 1200 iterations; the best checkpoint's prediction of each val crop
   (0:8, 0:64, 0:64) is decoded by ``mutex_watershed_segmentation`` (foreground
   all ones, ``min_size=10``) and scored against its labels: VOI (split +
   merge), adapted Rand error, 1 - Rand index (the number that script stores
   as ``adapted_rand_error``) and matching F1 at IoU 0.5. The summary sets
   the seeds' VOI (and its split and merge parts), F1, adapted Rand error and
   1 - Rand index beside the JAX package's seeds on the CPU
   (``scripts/records/jax_cpu_quality_seeds.json``, written by
   ``scripts/jax_quality_seeds.py``): both sides' mean and std, the gap and
   Welch's t, a miss at |t| >= 2 on VOI or F1; as history, the JAX
   package's one TPU run (mean VOI 0.6389, mean F1 0.3119,
   ``parity_out_affinity/affinity_mws_results.json``) with the one-sample t.

``--deterministic`` runs with TF32 off and deterministic algorithms on
(``deterministic``): the same seed then gives the same weights bitwise
(each run records the sha256 of its best checkpoint's weights). Writes
``OUT/<mode>_results.json`` (``OUT/boundary_tracked_results.json`` at the
tracked scale) with cuDNN's and the matmuls' TF32 and determinism flags and
prints the card's name and power limit and the summary as the last line.
"""

import argparse
import contextlib
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch_em_tpu_torch as port  # noqa: E402
from chip_smoke import nvidia_smi  # noqa: E402
from torch_em_tpu_torch.loss import ApplyAndRemoveMask, DiceLoss, LossWrapper  # noqa: E402
from torch_em_tpu_torch.metric import matching, rand_index, variation_of_information  # noqa: E402
from torch_em_tpu_torch.ops.device import DeviceBoundaryTransform  # noqa: E402
from torch_em_tpu_torch.transforms import AffinityTransform, BoundaryTransform  # noqa: E402
from torch_em_tpu_torch.utils.segmentation import mutex_watershed_segmentation  # noqa: E402
from torch_em_tpu_torch.utils.test import make_volume  # noqa: E402

DATA_SEED, N_TRAIN, N_VAL, VOLUME = 13, 6, 2, (24, 96, 96)
PATCH = (8, 64, 64)
VAL_ROI = tuple(slice(0, p) for p in PATCH)
SCALE_FACTORS = [[1, 2, 2], [2, 2, 2]]
AFFINITY_OFFSETS = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [-2, 0, 0], [0, -3, 0], [0, 0, -3]]
ITERATIONS = {"boundary": 1500, "affinity": 1200}
SAMPLES_PER_EPOCH = 50
# the tracked scale (boundary mode): make_data3d.py --shape 40,320,320 --n-train 4 --n-val 2, train_tpu3d.py
# --device-transform --patch 32,256,256 --features 32 --tracked-model, 1000 iterations
TRACKED_VOLUME, TRACKED_N_TRAIN, TRACKED_N_VAL = (40, 320, 320), 4, 2
TRACKED_PATCH, TRACKED_ITERATIONS, TRACKED_VAL_SAMPLES = (32, 256, 256), 1000, 8
TRACKED_MODEL = dict(in_channels=1, out_channels=1, initial_features=32,
                     scale_factors=[[1, 2, 2], [1, 2, 2], [2, 2, 2], [2, 2, 2]], anisotropic_kernel=True,
                     final_activation="Sigmoid")

# experiments/parity/parity_r5_summary.json, "cremi3d_free_seeds_r5": the soft boundary
# Dice of seeds 0-15 under the pb protocol
JAX_BOUNDARY_DICE = [0.9339, 0.8427, 0.9491, 0.9597, 0.9165, 0.962, 0.967, 0.9668,
                     0.9582, 0.9476, 0.9622, 0.919, 0.9659, 0.9597, 0.9648, 0.9629]
REFERENCE_BOUNDARY_DICE = [0.9632, 0.9624, 0.9434, 0.9672, 0.9734, 0.9706, 0.8998, 0.9633,
                           0.924, 0.9426, 0.9555, 0.9629, 0.9586, 0.9651, 0.9683, 0.9257]
# experiments/parity/parity_out_affinity/affinity_mws_results.json: the JAX package's one run
JAX_AFFINITY = {"mean_voi": 0.6389, "mean_f1": 0.3119}
# experiments/parity/parity_out3d_tracked/parity_table3d.json: the tracked scale's boundary Dice, the JAX
# package's one run and the reference's
JAX_TRACKED_DICE, REFERENCE_TRACKED_DICE = 0.9847, 0.9838
# a quality point is a hit when the port's mean lies within this share of its yardstick (the north star's rule)
HIT_SHARE = 0.01
# the SNEMI and SPOCO points against the JAX package's seeds on the CPU: a miss at |Welch t| >= MISS_T
MISS_T = 2.0
JAX_CPU_RECORD = os.path.join(REPO, "scripts", "records", "jax_cpu_quality_seeds.json")
# the SNEMI point's metrics, each with the record's key for it
AFFINITY_KEYS = (("mean_voi", "mean_voi"), ("mean_f1", "mean_f1"), ("mean_voi_split", "mean_voi_split"),
                 ("mean_voi_merge", "mean_voi_merge"), ("mean_adapted_rand_error", "mean_adapted_rand_error"),
                 ("mean_one_minus_rand_index", "mean_one_minus_rand_index"))


class CurveLog:
    """A trainer logger that records each step's training loss and learning rate and each validation's
    metric; it reads them and changes no step."""

    def __init__(self, trainer, save_root, **kwargs):
        self.losses, self.lrs, self.metrics = [], [], []

    def log_train(self, step, loss, lr, x, y, prediction, log_gradients=False):
        self.losses.append(loss)
        self.lrs.append(lr)

    def log_validation(self, step, metric, loss, x, y, prediction):
        self.metrics.append(metric)

    def curves(self, steps_per_epoch):
        """Per epoch: the mean training loss, the learning rate and the validation metric."""
        starts = range(0, len(self.losses), steps_per_epoch)
        return {"train_loss": [float(np.mean(self.losses[i:i + steps_per_epoch])) for i in starts],
                "lr": [self.lrs[i] for i in starts], "val_metric": list(self.metrics)}


def backend_flags():
    """The switches that decide the card's arithmetic in these runs."""
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "cudnn.benchmark": torch.backends.cudnn.benchmark,
            "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
            "deterministic_warn_only": torch.is_deterministic_algorithms_warn_only_enabled(),
            "CUBLAS_WORKSPACE_CONFIG": os.environ.get("CUBLAS_WORKSPACE_CONFIG")}


@contextlib.contextmanager
def deterministic(on=True):
    """``--deterministic`` for the block when ``on``: float32 without TF32 and the same result from the
    same seed. cuBLAS gets a fixed workspace (set before its first call), cuDNN takes deterministic
    algorithms without benchmarking, and ``torch.use_deterministic_algorithms(True)`` makes every other
    op deterministic or raise; the 3-D U-Nets then pool through ``models/unet.py:window_max_pool``,
    whose backward is deterministic (``F.max_pool3d``'s raises in that mode on the card). The flags are
    as they were after the block."""
    if not on:
        yield
        return
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.benchmark,
           torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    try:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = old[:4]
        torch.use_deterministic_algorithms(old[4], warn_only=old[5])


def read_runs(paths):
    """The runs of the result files ``paths``, one per seed (the first file that holds a seed gives it), and
    each file's device, card and flags."""
    runs, sources = {}, []
    for path in paths:
        with open(path) as f:
            result = json.load(f)
        sources.append({"file": path, "device": result["device"], "card": result["card"],
                        "backend": result.get("backend"), "seeds": [r["seed"] for r in result["runs"]]})
        for run in result["runs"]:
            runs.setdefault(run["seed"], run)
    return [runs[seed] for seed in sorted(runs)], sources


def state_digest(model) -> str:
    """The sha256 of a model's state, tensor by tensor in order: equal digests mean bitwise equal weights."""
    h = hashlib.sha256()
    for name, tensor in model.state_dict().items():
        h.update(name.encode())
        h.update(tensor.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def jax_cpu_record(mode):
    """The JAX package's seeds of ``mode`` ("spoco" or "affinity") on the CPU: the record that
    ``scripts/jax_quality_seeds.py`` writes (``scripts/records/jax_cpu_quality_seeds.json``)."""
    with open(JAX_CPU_RECORD) as f:
        return json.load(f)["modes"][mode]


def against_jax_cpu(runs, mode, keys):
    """For each (port key, record key) of ``keys``: both sides' mean and std over their seeds, the gap,
    Welch's t and whether it is a miss (|t| >= MISS_T, the rule of PERF.md section 2)."""
    record = jax_cpu_record(mode)
    out = {"jax_cpu_seeds": [s["seed"] for s in record["seeds"]], "port_seeds": [r["seed"] for r in runs]}
    for key, record_key in keys:
        port_values, jax_values = [r[key] for r in runs], [s[record_key] for s in record["seeds"]]
        entry = {"port": distribution(port_values), "jax_cpu": distribution(jax_values),
                 "mean_gap": float(np.mean(port_values) - np.mean(jax_values)), "welch_t": None, "welch_dof": None,
                 "miss": None}
        if len(port_values) > 1 and len(jax_values) > 1 and (np.std(port_values) or np.std(jax_values)):
            entry["welch_t"], entry["welch_dof"] = welch(port_values, jax_values)
            entry["miss"] = bool(abs(entry["welch_t"]) >= MISS_T)
        out[key] = entry
    return out


def one_sample_t(values, value):
    """The one-sample t of ``values`` against a single ``value`` (None for fewer than two values or no spread)."""
    values = np.asarray(values, dtype=np.float64)
    std = values.std(ddof=1) if len(values) > 1 else 0.0
    return float((values.mean() - value) / (std / np.sqrt(len(values)))) if std else None


def hit(mean, yardstick):
    """The north star's rule: the relative gap of ``mean`` to ``yardstick`` and whether it lies within HIT_SHARE."""
    relative = (mean - yardstick) / yardstick
    return {"yardstick": yardstick, "relative_gap": relative, "hit": bool(abs(relative) <= HIT_SHARE)}


def identity(raw):
    """The raw transform of the boundary protocol: both sides of the JAX probe fed raw [0, 1]."""
    return raw


def no_augmentation(raw, labels):
    return raw, labels


def labels_digest(labels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(labels, dtype=np.uint32).tobytes()).hexdigest()


def make_data(folder, scale="probe", n_train=None, n_val=None):
    """The volumes of ``scale`` as ``.npy`` under ``folder``/{train,val}; returns {split: [(raw, labels,
    boundaries) paths]} and prints each labels volume's sha256. ``n_train``/``n_val`` cut a split to its
    first volumes (drawn in the same order, so a cut train split moves the val volumes)."""
    if scale == "probe":
        shape, counts = VOLUME, (N_TRAIN, N_VAL)
    else:
        shape, counts = TRACKED_VOLUME, (TRACKED_N_TRAIN, TRACKED_N_VAL)
    counts = [c if n is None else n for c, n in zip(counts, (n_train, n_val))]
    rng = np.random.default_rng(DATA_SEED)
    boundaries = BoundaryTransform(mode="thick", ndim=3)
    paths = {}
    for split, n in zip(("train", "val"), counts):
        os.makedirs(os.path.join(folder, split), exist_ok=True)
        paths[split] = []
        for i in range(n):
            raw, labels = make_volume(rng, shape)
            files = tuple(os.path.join(folder, split, f"vol{i}_{key}.npy") for key in ("raw", "labels", "boundaries"))
            for file, data in zip(files, (raw, labels, boundaries(labels).astype("float32")[0])):
                np.save(file, data)
            paths[split].append(files)
            print(f"data {split}/vol{i}: raw {raw.shape} {raw.dtype}, labels sha256 {labels_digest(labels)}",
                  flush=True)
    return paths


def soft_dice(pred, target, eps=1e-7):
    """``experiments/parity/evaluate3d.py:soft_dice``."""
    p, t = pred.reshape(-1), target.reshape(-1)
    return float(2 * (p * t).sum() / max((p * p).sum() + (t * t).sum(), eps))


def welch(a, b):
    """Welch's t of mean(a) - mean(b) and its Welch-Satterthwaite degrees of freedom."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    va, vb = a.var(ddof=1) / len(a), b.var(ddof=1) / len(b)
    t = (a.mean() - b.mean()) / np.sqrt(va + vb)
    dof = (va + vb) ** 2 / (va ** 2 / (len(a) - 1) + vb ** 2 / (len(b) - 1))
    return float(t), float(dof)


def distribution(values):
    values = np.asarray(values, dtype=np.float64)
    return {"n": len(values), "mean": float(values.mean()),
            "std": float(values.std(ddof=1)) if len(values) > 1 else None}


def predict_crops(model, val, device, roi=VAL_ROI):
    """The model's predictions (N_VAL, C, *patch) on the val volumes' ``roi``, float32 on the host."""
    model.eval()
    raws = np.stack([np.load(r)[roi] for r, _, _ in val])[:, None]
    with torch.no_grad():
        return np.concatenate([model(torch.from_numpy(x[None]).to(device)).float().cpu().numpy() for x in raws])


def train_boundary(paths, seed, iterations, device, out, scale="probe"):
    """Train and score one seed; returns its result and the trainer (best checkpoint loaded)."""
    train, val = paths["train"], paths["val"]
    if scale == "probe":
        patch, roi = PATCH, VAL_ROI
        train_loader = port.default_segmentation_loader(
            [r for r, _, _ in train], None, [b for _, _, b in train], None, batch_size=1, patch_shape=PATCH, ndim=3,
            label_dtype="float32", raw_transform=identity, n_samples=SAMPLES_PER_EPOCH)
        val_loader = port.default_segmentation_loader(
            [r for r, _, _ in val], None, [b for _, _, b in val], None, batch_size=1, patch_shape=PATCH, ndim=3,
            label_dtype="float32", raw_transform=identity, rois=[VAL_ROI] * len(val), transform=no_augmentation)
        model = port.AnisotropicUNet(in_channels=1, out_channels=1, initial_features=8, scale_factors=SCALE_FACTORS,
                                     final_activation="Sigmoid", device=device, seed=seed)
        device_targets = None
    else:
        patch = TRACKED_PATCH
        roi = tuple(slice(0, p) for p in patch)

        def loader(files, n_samples):
            return port.default_segmentation_loader(
                [r for r, _, _ in files], None, [lab for _, lab, _ in files], None, batch_size=1, patch_shape=patch,
                ndim=3, label_dtype="float32", raw_transform=identity, n_samples=n_samples)

        train_loader, val_loader = loader(train, SAMPLES_PER_EPOCH), loader(val, TRACKED_VAL_SAMPLES)
        model = port.AnisotropicUNet(**TRACKED_MODEL, device=device, seed=seed)
        device_targets = DeviceBoundaryTransform(ndim=3)
    trainer = port.default_segmentation_trainer(
        f"parity-boundary-{scale}-s{seed}", model, train_loader, val_loader, learning_rate=1e-4,
        optimizer_kwargs={"weight_decay": 0.01}, device=device, save_root=out, logger=CurveLog,
        device_label_transform=device_targets)
    trainer.fit(iterations=iterations)
    trained = trainer.iteration
    trainer.load_checkpoint("best")
    preds = predict_crops(trainer.model, val, device, roi)
    targets = np.stack([np.load(b)[roi] for _, _, b in val])[:, None]
    run = {"seed": seed, "dice_boundary": soft_dice(preds, targets), "best_val_metric": trainer.best_metric,
           "iterations": trained, "best_checkpoint_iteration": trainer.iteration,
           "best_state_sha256": state_digest(trainer.model),
           "curves": trainer.logger.curves(len(train_loader))}
    return run, trainer


def affinity_loader(files, n_samples):
    """The affinity probe's loader over ``files`` [(raw, labels, boundaries) paths]: random patches
    with the default augmentations and the affinity targets, as ``train_affinity3d.py``'s."""
    trafo = AffinityTransform(offsets=AFFINITY_OFFSETS, add_binary_target=True, add_mask=True)
    return port.default_segmentation_loader(
        [r for r, _, _ in files], None, [lab for _, lab, _ in files], None, batch_size=1, patch_shape=PATCH,
        ndim=3, label_transform2=trafo, label_dtype="float32", n_samples=n_samples)


def train_affinity(paths, seed, iterations, device, out):
    train, val = paths["train"], paths["val"]
    loss = LossWrapper(DiceLoss(), transform=ApplyAndRemoveMask())
    model = port.AnisotropicUNet(in_channels=1, out_channels=1 + len(AFFINITY_OFFSETS), initial_features=8,
                                 scale_factors=SCALE_FACTORS, final_activation="Sigmoid", device=device, seed=seed)
    train_loader = affinity_loader(train, SAMPLES_PER_EPOCH)
    trainer = port.default_segmentation_trainer(
        f"parity-affinity-s{seed}", model, train_loader, affinity_loader(val, 8),
        loss=loss, metric=loss, learning_rate=1e-4, device=device, save_root=out, logger=CurveLog)
    trainer.fit(iterations=iterations)
    trained = trainer.iteration
    trainer.load_checkpoint("best")
    preds = predict_crops(trainer.model, val, device)
    volumes, decode_s = [], 0.0
    for pred, (_, lab, _) in zip(preds, val):
        gt = np.load(lab)[VAL_ROI].astype("uint64")
        t = time.perf_counter()
        seg = mutex_watershed_segmentation(np.ones_like(pred[0]), pred[1:], offsets=AFFINITY_OFFSETS, min_size=10)
        decode_s += time.perf_counter() - t
        vi_split, vi_merge = variation_of_information(seg, gt)
        are, ri = rand_index(seg, gt)
        volumes.append({"voi_split": vi_split, "voi_merge": vi_merge, "adapted_rand_error": are,
                        "one_minus_rand_index": 1.0 - ri, "matching_f1@0.5": matching(seg, gt)["f1"],
                        "n_pred_instances": int(len(np.unique(seg)) - 1),
                        "n_gt_instances": int(len(np.unique(gt)) - 1)})
    run = {"seed": seed, "best_val_metric": trainer.best_metric, "iterations": trained,
           "best_checkpoint_iteration": trainer.iteration, "best_state_sha256": state_digest(trainer.model),
           "per_volume": volumes, "decode_s": decode_s,
           "mean_voi": float(np.mean([v["voi_split"] + v["voi_merge"] for v in volumes])),
           "mean_f1": float(np.mean([v["matching_f1@0.5"] for v in volumes])),
           "mean_voi_split": float(np.mean([v["voi_split"] for v in volumes])),
           "mean_voi_merge": float(np.mean([v["voi_merge"] for v in volumes])),
           "mean_adapted_rand_error": float(np.mean([v["adapted_rand_error"] for v in volumes])),
           "mean_one_minus_rand_index": float(np.mean([v["one_minus_rand_index"] for v in volumes])),
           "curves": trainer.logger.curves(len(train_loader))}
    return run, trainer


def summarize(mode, runs, scale="probe"):
    if mode == "boundary" and scale == "tracked":
        dice = [r["dice_boundary"] for r in runs]
        summary = {"port": distribution(dice)}
        summary["vs_jax"] = {"jax_n1": JAX_TRACKED_DICE, "mean_gap": summary["port"]["mean"] - JAX_TRACKED_DICE,
                             "one_sample_t": one_sample_t(dice, JAX_TRACKED_DICE)}
        summary["vs_reference"] = {"reference_n1": REFERENCE_TRACKED_DICE,
                                   "mean_gap": summary["port"]["mean"] - REFERENCE_TRACKED_DICE}
        summary["hit"] = hit(summary["port"]["mean"], JAX_TRACKED_DICE)
        return summary
    if mode == "boundary":
        dice = [r["dice_boundary"] for r in runs]
        summary = {"port": distribution(dice), "jax": distribution(JAX_BOUNDARY_DICE),
                   "reference": distribution(REFERENCE_BOUNDARY_DICE)}
        for side, values in (("jax", JAX_BOUNDARY_DICE), ("reference", REFERENCE_BOUNDARY_DICE)):
            gap = summary["port"]["mean"] - summary[side]["mean"]
            t, dof = welch(dice, values) if len(dice) > 1 else (None, None)
            summary[f"vs_{side}"] = {"mean_gap": gap, "welch_t": t, "welch_dof": dof}
        return summary
    summary = {"vs_jax_cpu": against_jax_cpu(runs, "affinity", AFFINITY_KEYS)}
    summary["miss"] = any(summary["vs_jax_cpu"][key]["miss"] for key in ("mean_voi", "mean_f1"))
    # history: the JAX package's one run on a TPU
    summary["vs_jax_tpu_run"] = {key: {"jax_n1": value, "mean_gap": float(np.mean([r[key] for r in runs]) - value),
                                       "one_sample_t": one_sample_t([r[key] for r in runs], value)}
                                 for key, value in JAX_AFFINITY.items()}
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", choices=("boundary", "affinity"), required=True)
    parser.add_argument("--scale", choices=("probe", "tracked"), default="probe",
                        help="tracked: the tracked CREMI model and scale (boundary mode only)")
    parser.add_argument("--seeds", type=int, nargs="+")
    parser.add_argument("-o", "--output")
    parser.add_argument("-n", "--iterations", type=int, default=None,
                        help="default: 1500 (boundary), 1000 (boundary, tracked) or 1200 (affinity), as the "
                             "JAX runs")
    parser.add_argument("--summarize", nargs="+", metavar="RESULTS",
                        help="print the summary of these result files' runs (one per seed) instead of training")
    parser.add_argument("-d", "--device", default="cuda")
    parser.add_argument("--deterministic", action="store_true",
                        help="TF32 off and deterministic algorithms on (see deterministic)")
    args = parser.parse_args(argv)
    if args.mode == "affinity" and args.scale == "tracked":
        parser.error("--scale tracked runs the boundary mode only")
    if args.summarize:
        runs, sources = read_runs(args.summarize)
        print(json.dumps({"sources": sources, "summary": summarize(args.mode, runs, args.scale)}))
        return 0
    if not (args.seeds and args.output):
        parser.error("--seeds and -o are needed unless --summarize is given")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_parity3d: no CUDA device is available; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    with deterministic(args.deterministic):
        return run_seeds(args)


def run_seeds(args):
    tracked = args.scale == "tracked"
    default = TRACKED_ITERATIONS if tracked else ITERATIONS[args.mode]
    iterations = default if args.iterations is None else args.iterations
    os.makedirs(args.output, exist_ok=True)
    paths = make_data(os.path.join(args.output, "data"), args.scale)
    runs = []
    for seed in args.seeds:
        np.random.seed(seed)
        torch.manual_seed(seed)
        t = time.perf_counter()
        if args.mode == "boundary":
            run, _ = train_boundary(paths, seed, iterations, args.device, args.output, args.scale)
        else:
            run, _ = train_affinity(paths, seed, iterations, args.device, args.output)
        run["seconds"] = time.perf_counter() - t
        runs.append(run)
        print(f"{args.mode} {args.scale} seed {seed}: "
              f"{json.dumps({k: v for k, v in run.items() if k != 'curves'})}", flush=True)
    result = {"mode": args.mode, "scale": args.scale, "device": args.device,
              "card": nvidia_smi() if args.device != "cpu" else None, "backend": backend_flags(),
              "iterations": iterations, "runs": runs, "summary": summarize(args.mode, runs, args.scale)}
    name = f"{args.mode}_tracked" if tracked else args.mode
    with open(os.path.join(args.output, f"{name}_results.json"), "w") as f:
        json.dump(result, f, indent=2)
    if result["card"]:
        print(result["card"], flush=True)
    print(json.dumps(result["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
