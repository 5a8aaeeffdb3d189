"""The port's SPOCO quality point: ``experiments/parity/train_spoco2d.py``, run with the port.

    python3 scripts/torch_spoco2d.py --seeds 0 1 2 3 --deterministic -o OUT
    python3 scripts/torch_spoco2d.py --seeds 0 --iterations 4 --device cpu -o OUT

Imports only the port (``torch_em_tpu_torch``), ``chip_smoke`` (for the
card's name and power limit) and ``scripts/torch_parity3d.py`` and
``scripts/torch_parity2d.py`` (their statistics and the DSB probe's data),
and runs on the card unless ``--device cpu``. Steps:

1. Data: the DSB probe's (``torch_parity2d.make_data``): regenerates
   ``experiments/parity/parity_data`` (``make_data.py``, seed 42: 128 train
   and 16 val images of 128x128) with the port's ``utils.test.make_image``
   and writes each image and its labels to ``OUT/data/<split>`` as
   ``.npy``; prints the sha256 of each split's labels (uint32, C order,
   images stacked) and fails unless it equals that of the tracked HDF5 file.
2. Training, per seed: ``UNet2d(1 -> 8, initial_features=16)`` with the
   seed as its init seed, batch 4, float32 (``mixed_precision=False``, as
   the JAX script: bf16 distance matrices overflow), ``SPOCOLoss(0.75, 2.0,
   max_instances=64)`` as loss and ``ContrastiveLoss`` as metric,
   ``SPOCOTrainer`` through ``default_segmentation_trainer`` (AdamW at lr
   1e-4, the plateau scheduler), 2000 iterations, over an
   ``ImageCollectionDataset`` of the ``.npy`` files (the JAX script's
   ``TensorDataset`` of the same arrays: the same class over files).
3. Decode: the best checkpoint's embeddings of val images 0-7 go through
   ``instance_segmentation_grid_search`` with the embedding mutex watershed
   (``with_background=True``) over delta {1.0, 1.5, 2.0, 2.5} x
   min_seg_size {50, 100, 200, 400}; the best setting decodes val images
   8-15, scored by VOI (split + merge), 1 - Rand index (the number the JAX
   script stores as ``adapted_rand_error``), the adapted Rand error, and
   the predicted and ground-truth instance counts.

``--deterministic`` runs with TF32 off and deterministic algorithms on
(``torch_parity3d.deterministic``): the same seed then gives the same
weights bitwise. Each seed records its training loss, learning rate and
validation metric per epoch and the sha256 of its best checkpoint's weights.

The summary sets the seeds' VOI, 1 - Rand index, adapted Rand error and
predicted instances beside the JAX package's seeds on the CPU
(``scripts/records/jax_cpu_quality_seeds.json``, written by
``scripts/jax_quality_seeds.py``): both sides' mean and std, the gap and
Welch's t, a miss at |t| >= 2. As history it keeps the JAX package's one
TPU run (mean VOI 1.2461, 1 - Rand index 0.2524, 6.9 predicted and 6.2
ground-truth instances; ``experiments/parity/parity_out_spoco/spoco_results.json``)
with the one-sample t of the seeds against it. Writes
``OUT/spoco_results.json`` with the backend's flags and prints the card's
name and power limit and the summary as the last line.
"""

import argparse
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
from torch_em_tpu_torch.loss import ContrastiveLoss, SPOCOLoss  # noqa: E402
from torch_em_tpu_torch.metric import rand_index, variation_of_information  # noqa: E402
from torch_em_tpu_torch.metric.instance_segmentation_metric import EmbeddingMWS  # noqa: E402
from torch_em_tpu_torch.trainer import SPOCOTrainer  # noqa: E402
from torch_em_tpu_torch.utils.grid_search import instance_segmentation_grid_search  # noqa: E402
from torch_parity2d import SCALES, make_data  # noqa: E402
from torch_parity3d import (CurveLog, against_jax_cpu, backend_flags, deterministic, distribution,  # noqa: E402
                            one_sample_t, read_runs, state_digest)

SIZE = SCALES["probe"]["size"]
EMBED_DIM, BATCH, ITERATIONS = 8, 4, 2000
OFFSETS = [[-1, 0], [0, -1], [-3, 0], [0, -3], [-9, 0], [0, -9]]
GRID = {"delta": [1.0, 1.5, 2.0, 2.5], "min_seg_size": [50, 100, 200, 400]}
# experiments/parity/parity_out_spoco/spoco_results.json: the JAX package's one run
# (its 6.2 ground-truth instances are the mean 6.25 of the same images, rounded)
JAX_SPOCO = {"mean_voi": 1.2461, "mean_one_minus_rand_index": 0.2524, "mean_pred_instances": 6.9}
# the point's metrics against the JAX package's seeds on the CPU, each with the record's key for it
SPOCO_KEYS = (("mean_voi", "mean_voi"), ("mean_one_minus_rand_index", "mean_one_minus_rand_index"),
              ("mean_adapted_rand_error", "mean_adapted_rand_error"), ("mean_pred_instances", "mean_pred_instances"))


def embed(model, image, device):
    """The model's embeddings (E, H, W) of one image, float32 on the host."""
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(np.ascontiguousarray(image)[None, None]).to(device))[0].float().cpu().numpy()


class EmbeddingMWSSegmenter:
    """``instance_segmentation_grid_search``'s segmenter: ``initialize`` keeps an image's
    embeddings, ``generate`` decodes them with one setting (as the JAX script's adapter)."""

    def __init__(self, model, device):
        self.model, self.device = model, device

    def initialize(self, image):
        self._emb = embed(self.model, image, self.device)

    def generate(self, delta=1.5, min_seg_size=150):
        return EmbeddingMWS(delta=delta, offsets=OFFSETS, with_background=True, min_seg_size=min_seg_size)(self._emb)


def train_seed(paths, seed, iterations, device, out):
    def loader(split, shuffle):
        raws, labels = paths[split]
        ds = ImageCollectionDataset(raws, labels, patch_shape=(SIZE, SIZE), label_dtype="int64")
        return port.get_data_loader(ds, batch_size=BATCH, shuffle=shuffle)

    model = port.UNet2d(in_channels=1, out_channels=EMBED_DIM, initial_features=16, device=device, seed=seed)
    trainer = port.default_segmentation_trainer(
        f"spoco-s{seed}", model, loader("train", True), loader("val", False),
        loss=SPOCOLoss(delta_var=0.75, delta_dist=2.0, max_instances=64),
        metric=ContrastiveLoss(delta_var=0.75, delta_dist=2.0, max_instances=64), learning_rate=1e-4,
        mixed_precision=False, device=device, save_root=out, logger=CurveLog, trainer_class=SPOCOTrainer)
    trainer.generator.manual_seed(seed)
    t = time.perf_counter()
    trainer.fit(iterations=iterations)
    train_s = time.perf_counter() - t
    trained = trainer.iteration
    trainer.load_checkpoint("best")

    raws, labels = paths["val"]
    n_tune = len(raws) // 2
    t = time.perf_counter()
    best_params, best_score = instance_segmentation_grid_search(
        EmbeddingMWSSegmenter(trainer.model, device), raws[:n_tune], labels[:n_tune],
        os.path.join(out, f"grid-s{seed}"), grid_search_values=GRID)
    grid_s = time.perf_counter() - t
    decoder = EmbeddingMWS(delta=best_params["delta"], offsets=OFFSETS, with_background=True,
                           min_seg_size=int(best_params["min_seg_size"]))
    images = []
    for raw_path, label_path in zip(raws[n_tune:], labels[n_tune:]):
        seg = decoder(embed(trainer.model, np.load(raw_path), device)).astype("uint64")
        gt = np.load(label_path).astype("uint64")
        vi_split, vi_merge = variation_of_information(seg, gt)
        are, ri = rand_index(seg, gt)
        images.append({"voi": vi_split + vi_merge, "one_minus_rand_index": 1.0 - ri, "adapted_rand_error": are,
                       "n_pred": int(len(np.unique(seg)) - 1), "n_gt": int(len(np.unique(gt)) - 1)})
    return {"seed": seed, "best_val_metric": trainer.best_metric, "iterations": trained,
            "best_checkpoint_iteration": trainer.iteration, "best_state_sha256": state_digest(trainer.model),
            "train_s": train_s, "grid_search_s": grid_s, "curves": trainer.logger.curves(len(trainer.train_loader)),
            "decode": {"delta": best_params["delta"], "min_seg_size": int(best_params["min_seg_size"]),
                       "tune_images": n_tune, "tune_accuracy": best_score},
            "per_image": images,
            "mean_voi": float(np.mean([r["voi"] for r in images])),
            "mean_one_minus_rand_index": float(np.mean([r["one_minus_rand_index"] for r in images])),
            "mean_adapted_rand_error": float(np.mean([r["adapted_rand_error"] for r in images])),
            "mean_pred_instances": float(np.mean([r["n_pred"] for r in images])),
            "mean_gt_instances": float(np.mean([r["n_gt"] for r in images]))}, trainer


def summarize(runs):
    summary = {"vs_jax_cpu": against_jax_cpu(runs, "spoco", SPOCO_KEYS)}
    summary["miss"] = any(summary["vs_jax_cpu"][key]["miss"] for key, _ in SPOCO_KEYS)
    summary["mean_gt_instances"] = distribution([r["mean_gt_instances"] for r in runs])
    # history: the JAX package's one run on a TPU
    summary["vs_jax_tpu_run"] = {key: {"jax_n1": value, "mean_gap": float(np.mean([r[key] for r in runs]) - value),
                                       "one_sample_t": one_sample_t([r[key] for r in runs], value)}
                                 for key, value in JAX_SPOCO.items()}
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+")
    parser.add_argument("-o", "--output")
    parser.add_argument("-n", "--iterations", type=int, default=ITERATIONS)
    parser.add_argument("-d", "--device", default="cuda")
    parser.add_argument("--deterministic", action="store_true",
                        help="TF32 off and deterministic algorithms on (torch_parity3d.deterministic)")
    parser.add_argument("--summarize", nargs="+", metavar="RESULTS",
                        help="print the summary of these result files' runs (one per seed) instead of training")
    args = parser.parse_args(argv)
    if args.summarize:
        runs, sources = read_runs(args.summarize)
        print(json.dumps({"sources": sources, "summary": summarize(runs)}))
        return 0
    if not (args.seeds and args.output):
        parser.error("--seeds and -o are needed unless --summarize is given")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_spoco2d: no CUDA device is available; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    with deterministic(args.deterministic):
        return run_seeds(args)


def run_seeds(args):
    os.makedirs(args.output, exist_ok=True)
    paths = make_data(os.path.join(args.output, "data"))
    runs = []
    for seed in args.seeds:
        np.random.seed(seed)
        torch.manual_seed(seed)
        t = time.perf_counter()
        run, _ = train_seed(paths, seed, args.iterations, args.device, args.output)
        run["seconds"] = time.perf_counter() - t
        runs.append(run)
        print(f"spoco seed {seed}: {json.dumps({k: v for k, v in run.items() if k != 'curves'})}", flush=True)
    result = {"device": args.device, "card": nvidia_smi() if args.device != "cpu" else None,
              "backend": backend_flags(), "iterations": args.iterations, "runs": runs, "summary": summarize(runs)}
    with open(os.path.join(args.output, "spoco_results.json"), "w") as f:
        json.dump(result, f, indent=2)
    if result["card"]:
        print(result["card"], flush=True)
    print(json.dumps(result["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
