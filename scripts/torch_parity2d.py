"""The port's DSB-2D quality points: ``experiments/parity/{make_data,train_tpu,evaluate}.py``, run with the port.

    python3 scripts/torch_parity2d.py --scale probe --seeds 0 1 2 3 4 --deterministic -o OUT
    python3 scripts/torch_parity2d.py --scale tracked --seeds 0 1 2 --deterministic -o OUT
    python3 scripts/torch_parity2d.py --scale probe --seeds 0 --iterations 4 --device cpu -o OUT

Imports only the port (``torch_em_tpu_torch``), ``chip_smoke`` (for the
card's name and power limit) and ``scripts/torch_parity3d.py`` (its
statistics and training-curve logger), and runs on the card unless
``--device cpu``. Steps:

1. Data: regenerates ``experiments/parity/parity_data`` (``--scale probe``)
   or ``parity_data256`` (``--scale tracked``): ``make_data.py`` with seed 42,
   128 train and 16 val images of 128x128 or 256x256, drawn train first, then
   val, on one ``default_rng(42)`` with the port's ``utils.test.make_image``.
   Writes each image and its labels to ``OUT/data/<split>`` as ``.npy``,
   prints the sha256 of each split's labels (uint32, C order, images stacked)
   and fails unless it equals that of the tracked HDF5 file.
2. Training, per seed (``train_tpu.py``): an ``ImageCollectionDataset`` of
   the ``.npy`` files (``train_tpu.py``'s ``TensorDataset`` of the same
   arrays is the same class over arrays, and the same samples; but it would
   write every image into the constructor spec of each checkpoint, 77 MB at
   the probe scale) with ``BoundaryTransform(mode="thick",
   add_binary_target=True, ndim=2)`` targets (float32) and the whole image as
   its patch, the default 2-D augmentations on train only,
   ``get_data_loader(shuffle=True)``;
   ``UNet2d(1 -> 2, Sigmoid)`` with the seed as its init seed;
   ``default_segmentation_trainer`` (AdamW at lr 1e-4, weight decay 0.01, the
   default plateau scheduler, bf16 compute with float32 parameters). Probe:
   f=16, batch 4, 1500 iterations; tracked: f=64, batch 8, 3000 iterations.
   A logger records the training loss, learning rate and validation metric
   per epoch; it reads them and changes no step.
3. Evaluation (``evaluate.py``): the best checkpoint's predictions of the 16
   val images, in batches of 4, scored by soft Dice per channel over the
   whole set against ``BoundaryTransform`` targets of the val labels:
   foreground, boundary and their mean. The run also records the sha256 of the
   best checkpoint's weights (``torch_parity3d.state_digest``): equal digests
   from two processes mean the seed repeats bitwise.

``--deterministic`` runs under ``torch_parity3d.deterministic`` (TF32 off,
cuDNN's deterministic algorithms without benchmarking, and
``torch.use_deterministic_algorithms(True)``); the result file records the
flags either way.

The summary sets the seeds' mean Dice beside the recorded yardsticks: at the
probe scale torch-em's and the JAX package's three runs each
(``experiments/parity/parity_out_s{0,1,2}/parity_table.json``), with the gap
and Welch's t against each; at the tracked scale the JAX package's one run
(``parity_out_tracked/parity_table.json``), with the gap and the one-sample
t. A point is a hit when the seeds' mean lies within 1% of its yardstick
(torch-em's mean at the probe scale, JAX's run at the tracked one). Writes
``OUT/dsb_<scale>_results.json`` and prints the card's name and power limit
and the summary as the last line.
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_em_tpu_torch as port  # noqa: E402
from chip_smoke import nvidia_smi  # noqa: E402
from torch_em_tpu_torch.data import ImageCollectionDataset  # noqa: E402
from torch_em_tpu_torch.transforms import BoundaryTransform, get_augmentations  # noqa: E402
from torch_em_tpu_torch.utils.test import make_image  # noqa: E402
from torch_parity3d import (CurveLog, backend_flags, deterministic, distribution, hit, one_sample_t,  # noqa: E402
                            state_digest, welch)

DATA_SEED, SPLITS = 42, (("train", 128), ("val", 16))
# make_data.py's image side, train_tpu.py's width, batch and iterations at each scale (the tracked one:
# experiments/parity/run_r3_all.sh, "-n 3000 --batch-size 8 --features 64 --seed 0")
SCALES = {"probe": dict(size=128, features=16, batch_size=4, iterations=1500),
          "tracked": dict(size=256, features=64, batch_size=8, iterations=3000)}
# sha256 of the labels of experiments/parity/parity_data{,256}/{train,val}.h5 (uint32, C order)
LABELS_SHA256 = {
    "probe": {"train": "411d047a7887f18dd38073db719ba3ac7a270232c846891a268c60527a8b6757",
              "val": "375682289ecf8e388ac4d58f5aa76b1ee71e865350322b7c0a85a73d5b99ac19"},
    "tracked": {"train": "6ad22ffc780ccdc841e2d5dae5119e5b9c95c821008d160bcdc1144d0a08d012",
                "val": "c6741ae941de362e2d40f0877a6f3b89ce9b76c8e3937c30ea40690c2bdb259e"},
}
EVAL_BATCH = 4
# experiments/parity/parity_out_s{0,1,2}/parity_table.json: mean Dice of seeds 0-2 at the probe scale
TORCH_EM_PROBE_DICE = [0.9802, 0.9804, 0.979]
JAX_PROBE_DICE = [0.9795, 0.9786, 0.9781]
# experiments/parity/parity_out_tracked/parity_table.json: the JAX package's one run at the tracked scale
JAX_TRACKED_DICE = {"dice_foreground": 0.9988, "dice_boundary": 0.9851, "dice_mean": 0.9919}


def labels_digest(labels) -> str:
    return hashlib.sha256(np.ascontiguousarray(labels, dtype=np.uint32).tobytes()).hexdigest()


def make_data(folder, scale="probe", n_train=None, n_val=None):
    """The images of ``scale`` as ``.npy`` under ``folder``/<split>; returns {split: ([raw paths], [label
    paths])}. ``n_train``/``n_val`` cut a split to its first images (drawn in the same order, so a cut
    train split moves the val images); only a whole split is checked against the tracked file's sha256."""
    size = SCALES[scale]["size"]
    rng = np.random.default_rng(DATA_SEED)
    paths = {}
    for split, published in SPLITS:
        n = {"train": n_train, "val": n_val}[split]
        n = published if n is None else n
        os.makedirs(os.path.join(folder, split), exist_ok=True)
        labels, paths[split] = [], ([], [])
        for i in range(n):
            raw, lab = make_image(rng, size=size)
            for files, name, data in zip(paths[split], ("raw", "labels"), (raw, lab)):
                files.append(os.path.join(folder, split, f"{name}_{i:03d}.npy"))
                np.save(files[-1], data)
            labels.append(lab)
        if n != published:
            print(f"data {split}: the first {n} of {published} images of {size}x{size}, not checked", flush=True)
            continue
        digest = labels_digest(np.stack(labels))
        print(f"data {split}: {n} images of {size}x{size}, labels sha256 {digest}", flush=True)
        if digest != LABELS_SHA256[scale][split]:
            raise RuntimeError(f"the regenerated {split} labels differ from the tracked {scale}-scale parity data")
    return paths


def dice_per_channel(pred: np.ndarray, target: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Soft Dice per channel over the whole set (``experiments/parity/evaluate.py:dice_per_channel``)."""
    c = pred.shape[1]
    p = np.transpose(pred, (1, 0, 2, 3)).reshape(c, -1)
    t = np.transpose(target, (1, 0, 2, 3)).reshape(c, -1)
    num = (p * t).sum(axis=1)
    den = np.maximum((p * p).sum(axis=1) + (t * t).sum(axis=1), eps)
    return 2 * num / den


def boundary_targets():
    return BoundaryTransform(mode="thick", add_binary_target=True, ndim=2)


def predict(model, raws, device):
    """The model's predictions (N, 2, H, W) of ``raws`` (N, H, W) in batches of EVAL_BATCH, float32 on the host."""
    model.eval()
    x = raws[:, None].astype("float32")
    with torch.no_grad():
        return np.concatenate([model(torch.from_numpy(x[i:i + EVAL_BATCH]).to(device)).float().cpu().numpy()
                               for i in range(0, len(x), EVAL_BATCH)])


def train_seed(paths, scale, seed, iterations, device, out):
    """Train and score one seed; returns its result and the trainer (best checkpoint loaded)."""
    config = SCALES[scale]
    patch_shape = (config["size"],) * 2
    train_ds = ImageCollectionDataset(*paths["train"], patch_shape=patch_shape, label_transform=boundary_targets(),
                                      transform=get_augmentations(ndim=2), label_dtype="float32")
    val_ds = ImageCollectionDataset(*paths["val"], patch_shape=patch_shape, label_transform=boundary_targets(),
                                    label_dtype="float32")
    train_loader = port.get_data_loader(train_ds, batch_size=config["batch_size"], shuffle=True)
    val_loader = port.get_data_loader(val_ds, batch_size=config["batch_size"])
    model = port.UNet2d(in_channels=1, out_channels=2, initial_features=config["features"],
                        final_activation="Sigmoid", device=device, seed=seed)
    trainer = port.default_segmentation_trainer(
        f"dsb-{scale}-s{seed}", model, train_loader, val_loader, learning_rate=1e-4,
        optimizer_kwargs={"weight_decay": 0.01}, device=device, save_root=out, logger=CurveLog)
    t = time.perf_counter()
    trainer.fit(iterations=iterations)
    train_s = time.perf_counter() - t
    trained = trainer.iteration
    trainer.load_checkpoint("best")
    raws, labels = paths["val"]
    preds = predict(trainer.model, np.stack([np.load(p) for p in raws]), device)
    targets = np.stack([boundary_targets()(np.load(p)).astype("float32") for p in labels])
    fg, bd = dice_per_channel(preds, targets)
    run = {"seed": seed, "dice_foreground": float(fg), "dice_boundary": float(bd),
           "dice_mean": float((fg + bd) / 2), "best_val_metric": trainer.best_metric, "iterations": trained,
           "best_checkpoint_iteration": trainer.iteration, "best_state_sha256": state_digest(trainer.model),
           "train_s": train_s,
           "curves": trainer.logger.curves(len(train_loader))}
    return run, trainer


def summarize(scale, runs):
    summary = {key: distribution([r[key] for r in runs])
               for key in ("dice_foreground", "dice_boundary", "dice_mean")}
    dice = [r["dice_mean"] for r in runs]
    mean = summary["dice_mean"]["mean"]
    if scale == "probe":
        for side, values in (("torch_em", TORCH_EM_PROBE_DICE), ("jax", JAX_PROBE_DICE)):
            t, dof = welch(dice, values) if len(dice) > 1 else (None, None)
            summary[f"vs_{side}"] = {"yardstick": distribution(values), "mean_gap": mean - float(np.mean(values)),
                                     "welch_t": t, "welch_dof": dof}
        summary["hit"] = hit(mean, float(np.mean(TORCH_EM_PROBE_DICE)))
    else:
        yardstick = JAX_TRACKED_DICE["dice_mean"]
        summary["vs_jax"] = {"jax_n1": JAX_TRACKED_DICE, "mean_gap": mean - yardstick,
                             "one_sample_t": one_sample_t(dice, yardstick)}
        summary["hit"] = hit(mean, yardstick)
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", choices=tuple(SCALES), required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("-n", "--iterations", type=int, default=None,
                        help="default: 1500 (probe) or 3000 (tracked), as the JAX runs")
    parser.add_argument("-d", "--device", default="cuda")
    parser.add_argument("--deterministic", action="store_true",
                        help="TF32 off and deterministic algorithms on (torch_parity3d.deterministic)")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_parity2d: no CUDA device is available; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    with deterministic(args.deterministic):
        return run_seeds(args)


def run_seeds(args):
    iterations = SCALES[args.scale]["iterations"] if args.iterations is None else args.iterations
    os.makedirs(args.output, exist_ok=True)
    paths = make_data(os.path.join(args.output, "data"), args.scale)
    runs = []
    for seed in args.seeds:
        np.random.seed(seed)
        torch.manual_seed(seed)
        t = time.perf_counter()
        run, _ = train_seed(paths, args.scale, seed, iterations, args.device, args.output)
        run["seconds"] = time.perf_counter() - t
        runs.append(run)
        print(f"dsb {args.scale} seed {seed}: "
              f"{json.dumps({k: v for k, v in run.items() if k != 'curves'})}", flush=True)
    result = {"scale": args.scale, "device": args.device, "card": nvidia_smi() if args.device != "cpu" else None,
              "backend": backend_flags(), "iterations": iterations, "config": SCALES[args.scale], "runs": runs,
              "summary": summarize(args.scale, runs)}
    with open(os.path.join(args.output, f"dsb_{args.scale}_results.json"), "w") as f:
        json.dump(result, f, indent=2)
    if result["card"]:
        print(result["card"], flush=True)
    print(json.dumps(result["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
