"""The JAX package's SPOCO and SNEMI quality points as seed distributions on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_quality_seeds.py --mode spoco --seeds 0 1 2 3 -o jax_quality_out/spoco
    JAX_PLATFORMS=cpu python scripts/jax_quality_seeds.py --mode affinity --seeds 0 1 2 3 4 5 \
        -o jax_quality_out/affinity
    python scripts/jax_quality_seeds.py --collect jax_quality_out/spoco jax_quality_out/affinity \
        --record scripts/records/jax_cpu_quality_seeds.json

Runs the recipes ``experiments/parity/train_spoco2d.py`` (``--mode spoco``,
2000 iterations, float32) and ``experiments/parity/train_affinity3d.py``
(``--mode affinity``, 1200 iterations, the recipe's mixed precision) by
calling their own ``main`` on the tracked probe data, with the seeding as
the only change. The recipes take no seed; for seed ``s`` this script

- builds the U-Net with ``seed=s`` (the recipe's class with that keyword bound);
- builds every loader with ``seed=s`` (the shuffle's generator);
- calls ``np.random.seed(s)`` before the datasets are built (the patch boxes
  of ``SegmentationDataset`` and ``ImageCollectionDataset`` come from the
  global ``np.random``);
- seeds each default augmentation pipeline's host generator from ``s``
  (the train loader's with ``[s, 0]``, the val loader's with ``[s, 1]``);
- replaces the trainer's key by ``jax.random.PRNGKey(s)`` right after
  ``default_segmentation_trainer`` builds it, which is what the trainer's
  ``seed=s`` would have set (the factory takes no seed).

Each seed writes ``OUT/<mode>_s<seed>/`` (the recipe's output folder) and
``OUT/<mode>_s<seed>.json``: the recipe's summary, the best checkpoint's
iteration and the wall time. ``--collect`` reads those files from the given
folders and writes the record (per seed, means and standard deviations, the
command, the CPU model and the ``jax`` version).

This script imports the JAX package; the port reads only the record it writes.
"""

import argparse
import contextlib
import functools
import glob
import importlib
import json
import os
import platform
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(REPO, "experiments", "parity")
DATA = {"spoco": os.path.join(PARITY, "parity_data"), "affinity": os.path.join(PARITY, "parity_data3d")}
ITERATIONS = {"spoco": 2000, "affinity": 1200}
RESULTS = {"spoco": "spoco_results.json", "affinity": "affinity_mws_results.json"}
# the summary fields the record keeps per seed, and whose mean and std it gives
METRICS = {"spoco": ("mean_voi", "mean_arand_error", "mean_one_minus_rand_index", "mean_adapted_rand_error",
                     "mean_pred_instances", "mean_gt_instances", "best_val_metric", "best_checkpoint_iteration"),
           "affinity": ("mean_voi", "mean_f1", "mean_voi_split", "mean_voi_merge", "mean_arand_error",
                        "mean_one_minus_rand_index", "mean_adapted_rand_error", "best_val_metric",
                        "best_checkpoint_iteration")}


def cpu_model():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def _pin_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


class _SeededPackage:
    """The recipes' ``torch_em`` module with its loader and trainer factories seeded; every other
    attribute is the package's own."""

    def __init__(self, package, seed, stop_before_fit=False):
        self._package, self._seed, self._loaders, self._stop = package, seed, 0, stop_before_fit

    def __getattr__(self, name):
        return getattr(self._package, name)

    def _seed_augmentations(self, loader):
        datasets = getattr(loader.dataset, "datasets", (loader.dataset,))
        for pipeline in {id(d.transform): d.transform for d in datasets if d.transform is not None}.values():
            if hasattr(pipeline, "_np_rng"):
                pipeline._np_rng = np.random.default_rng([self._seed, self._loaders])
        self._loaders += 1
        return loader

    def get_data_loader(self, dataset, batch_size, **kwargs):
        return self._seed_augmentations(self._package.get_data_loader(dataset, batch_size, seed=self._seed, **kwargs))

    def default_segmentation_loader(self, *args, **kwargs):
        return self._seed_augmentations(self._package.default_segmentation_loader(*args, seed=self._seed, **kwargs))

    def default_segmentation_trainer(self, *args, **kwargs):
        import jax
        trainer = self._package.default_segmentation_trainer(*args, **kwargs)
        trainer._rng = jax.random.PRNGKey(self._seed)
        trainer.seed = self._seed
        trainer._explicit_init_kwargs["seed"] = self._seed
        if self._stop:
            def fit(*args, **kwargs):
                raise _Built(trainer)
            trainer.fit = fit
        return trainer


class _Built(Exception):
    """Raised by a trainer's ``fit`` in ``build_seeded``: it carries the trainer the recipe built."""

    def __init__(self, trainer):
        super().__init__("built")
        self.trainer = trainer


@contextlib.contextmanager
def seeded_recipe(mode, seed, out, iterations, stop_before_fit=False):
    """The recipe module of ``mode`` with its seeding set for ``seed`` and ``sys.argv`` set to run it on the
    tracked data into ``out``; yields (recipe, scores), where ``scores`` collects each ``rand_index``
    result of its scoring. With ``stop_before_fit`` the trainer's ``fit`` raises ``_Built``."""
    _pin_cpu()
    for path in (REPO, PARITY):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch_em_tpu
    recipe = importlib.import_module("train_spoco2d" if mode == "spoco" else "train_affinity3d")
    model_class = "UNet2d" if mode == "spoco" else "AnisotropicUNet"
    original = (recipe.torch_em, getattr(recipe, model_class), recipe.rand_index, sys.argv)
    package = _SeededPackage(torch_em_tpu, seed, stop_before_fit)
    scores = []

    def rand_index(*args, **kwargs):
        # the recipes keep 1 - Rand index only; this keeps the adapted Rand error beside it
        scores.append(original[2](*args, **kwargs))
        return scores[-1]

    recipe.torch_em, recipe.rand_index = package, rand_index
    setattr(recipe, model_class, functools.partial(original[1], seed=seed))
    sys.argv = [recipe.__file__, "-d", DATA[mode], "-o", out, "-n", str(iterations)]
    np.random.seed(seed)
    try:
        yield recipe, scores
    finally:
        recipe.torch_em, recipe.rand_index, sys.argv = original[0], original[2], original[3]
        setattr(recipe, model_class, original[1])


def build_seeded(mode, seed, out):
    """The recipe's trainer for ``seed`` as it stands when the recipe calls ``fit``: its model initialised
    and its loaders seeded, nothing trained."""
    with seeded_recipe(mode, seed, out, ITERATIONS[mode], stop_before_fit=True) as (recipe, _):
        try:
            recipe.main()
        except _Built as built:
            return built.trainer
    raise RuntimeError(f"the {mode} recipe ended without calling fit")


def run_seed(mode, seed, out, iterations, command=None):
    """Run one recipe for one seed; returns the record's entry for it."""
    folder = os.path.join(out, f"{mode}_s{seed}")
    t = time.perf_counter()
    with seeded_recipe(mode, seed, folder, iterations) as (recipe, scores):
        recipe.main()
    wall_s = time.perf_counter() - t
    with open(os.path.join(folder, RESULTS[mode])) as f:
        summary = json.load(f)
    entry = {"seed": seed, "wall_s": wall_s, "trained_iterations": iterations, "command": command,
             # the recipes load the best checkpoint before they write "iterations"
             "best_checkpoint_iteration": summary["iterations"], "summary": summary}
    entry.update(seed_metrics(mode, summary))
    entry["adapted_rand_error"] = [float(are) for are, _ in scores]
    entry["one_minus_rand_index"] = [float(1.0 - ri) for _, ri in scores]
    entry["mean_adapted_rand_error"] = float(np.mean(entry["adapted_rand_error"]))
    entry["mean_one_minus_rand_index"] = float(np.mean(entry["one_minus_rand_index"]))
    with open(os.path.join(out, f"{mode}_s{seed}.json"), "w") as f:
        json.dump(entry, f, indent=2)
    return entry


def seed_metrics(mode, summary):
    """The per-seed numbers the record compares: the recipe's means, and SNEMI's VOI split and merge."""
    metrics = {"best_val_metric": summary["best_val_metric"], "mean_voi": summary["mean_voi"]}
    if mode == "spoco":
        metrics.update(mean_arand_error=summary["mean_arand_error"],
                       mean_pred_instances=summary["mean_pred_instances"],
                       mean_gt_instances=summary["mean_gt_instances"], decode=summary["decode"])
    else:
        volumes = summary["per_volume"]
        metrics.update(mean_f1=summary["mean_f1"],
                       mean_voi_split=float(np.mean([v["voi_split"] for v in volumes])),
                       mean_voi_merge=float(np.mean([v["voi_merge"] for v in volumes])),
                       mean_arand_error=float(np.mean([v["adapted_rand_error"] for v in volumes])))
    return metrics


def distribution(values):
    values = np.asarray(values, dtype=np.float64)
    return {"n": len(values), "mean": float(values.mean()),
            "std": float(values.std(ddof=1)) if len(values) > 1 else None}


def collect(folders, record_path, command):
    """Write the record from the per-seed files under ``folders``."""
    import jax
    record = {"what": "the JAX package's SPOCO and SNEMI probe recipes, one run per seed on the CPU, "
                      "seeded as scripts/jax_quality_seeds.py says; 'mean_arand_error' is the recipes' "
                      "'adapted_rand_error', which is 1 - Rand index",
              "command": command, "cpu": cpu_model(), "jax": jax.__version__,
              "python": platform.python_version(), "modes": {}}
    for mode in ("spoco", "affinity"):
        entries = []
        for folder in folders:
            for path in sorted(glob.glob(os.path.join(folder, f"{mode}_s*.json"))):
                with open(path) as f:
                    entries.append(json.load(f))
        if not entries:
            continue
        entries.sort(key=lambda e: e["seed"])
        seeds = [{k: v for k, v in e.items() if k != "summary"} for e in entries]
        for s, e in zip(seeds, entries):
            s["config"] = e["summary"]["config"]
        record["modes"][mode] = {
            "recipe": f"experiments/parity/{'train_spoco2d' if mode == 'spoco' else 'train_affinity3d'}.py",
            "iterations": entries[0]["trained_iterations"],
            "seeds": seeds,
            "summary": {key: distribution([e[key] for e in entries]) for key in METRICS[mode] + ("wall_s",)}}
    os.makedirs(os.path.dirname(os.path.abspath(record_path)), exist_ok=True)
    with open(record_path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return record


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", choices=("spoco", "affinity"))
    parser.add_argument("--seeds", type=int, nargs="+")
    parser.add_argument("-o", "--output")
    parser.add_argument("-n", "--iterations", type=int, default=None,
                        help="default: 2000 (spoco) or 1200 (affinity)")
    parser.add_argument("--collect", nargs="+", metavar="FOLDER", help="write the record from these folders")
    parser.add_argument("--record", default=os.path.join(REPO, "scripts", "records", "jax_cpu_quality_seeds.json"))
    args = parser.parse_args(argv)
    if args.collect:
        record = collect(args.collect, args.record, " ".join(["python", "scripts/jax_quality_seeds.py"]
                                                             + (sys.argv[1:] if argv is None else argv)))
        print(json.dumps({m: v["summary"] for m, v in record["modes"].items()}))
        return 0
    if not (args.mode and args.seeds and args.output):
        parser.error("--mode, --seeds and -o are needed unless --collect is given")
    iterations = ITERATIONS[args.mode] if args.iterations is None else args.iterations
    command = " ".join(["python", "scripts/jax_quality_seeds.py"] + (sys.argv[1:] if argv is None else argv))
    os.makedirs(args.output, exist_ok=True)
    for seed in args.seeds:
        entry = run_seed(args.mode, seed, args.output, iterations, command)
        print(f"{args.mode} seed {seed}: {json.dumps({k: v for k, v in entry.items() if k != 'summary'})}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
