"""Fit the Shallow2Deep forests that ``chip_smoke.py`` phase 16 trains its enhancer on, with the port alone.

    python3 scripts/torch_s2d_forests.py --check         # refit and compare with scripts/s2d_forests/
    python3 scripts/torch_s2d_forests.py -o OUT --seed 0  # refit and write OUT/rf_XXXX.npz and .pkl

Needs no scikit-learn: the port's ``prepare_shallow2deep`` fits with
``shallow2deep.forest.fit_forest``, which gives sklearn's trees node for node.
The committed forests ``scripts/s2d_forests/rf_000{0..3}.npz`` were fitted
by sklearn 1.9 through the same recipe and are kept as they are; ``--check``
holds the refitted forests against them node for node. Steps:

1. Data: the first ``TRAIN_IMAGES`` images of ``s2d_images(seed)``, 512x512
   EM-like images with mitochondria (``utils.test.make_mito_image``), the
   images phase 16 trains the enhancer on, stacked into one (8, 512, 512)
   ``.npy`` volume with its labels in a temporary folder.
2. Forests: ``prepare_shallow2deep`` with ``np.random.seed(seed)``, one
   thread, 4 forests of ``n_estimators=10, random_state=seed`` (sklearn's
   other defaults), each on one patch of 128x128 to 192x192 pixels, the
   default filter bank (28 features in 2-D) and ``ForegroundTransform``
   targets (label balancing on).
3. The sha256 of every forest's features and labels, in order: it tells
   whether another machine's scipy computed the same filter bank
   (``scripts/records/forest/s2d_recipe.json`` holds this CPU's).
"""

import argparse
import contextlib
import hashlib
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from torch_em_tpu_torch.shallow2deep import ForegroundTransform, load_forest, node_differences  # noqa: E402
from torch_em_tpu_torch.utils.test import make_mito_image  # noqa: E402

TRAIN_IMAGES, TEST_IMAGES, IMAGE_SIZE = 8, 2, 512
N_FORESTS, N_ESTIMATORS = 4, 10
PATCH_MIN, PATCH_MAX = (1, 128, 128), (1, 192, 192)
FOREST_DIR = os.path.join(REPO, "scripts", "s2d_forests")
RECIPE_RECORD = os.path.join(REPO, "scripts", "records", "forest", "s2d_recipe.json")


def s2d_images(seed: int = 0, n: int = TRAIN_IMAGES + TEST_IMAGES, size: int = IMAGE_SIZE):
    """``n`` seeded images and labels of ``make_mito_image``: (n, size, size) float32 and uint32.
    The first ``TRAIN_IMAGES`` fit the forests and train the enhancer, the rest test it."""
    rng = np.random.default_rng(seed)
    raws, labels = zip(*(make_mito_image(rng, size) for _ in range(n)))
    return np.stack(raws), np.stack(labels)


@contextlib.contextmanager
def _digest_of_fits(prepare, digest):
    """Feed the features and labels of every forest that ``prepare`` fits, in order, to ``digest``."""
    fit = prepare._fit_forest

    def fit_and_digest(features, labels, *args):
        for arr in (features, labels):
            digest.update(f"{arr.dtype.str}{arr.shape}".encode())
            digest.update(np.ascontiguousarray(arr).tobytes())
        return fit(features, labels, *args)

    prepare._fit_forest = fit_and_digest
    try:
        yield
    finally:
        prepare._fit_forest = fit


def fit_forests(out: str, seed: int = 0):
    """Fit the forests with the port and write their ``.npz`` files and sklearn pickles (``.pkl``, written
    without sklearn) to ``out``. Returns the ``.npz`` paths, the sha256 of the forests' features and
    labels, and the seconds of ``prepare_shallow2deep``."""
    prepare = importlib.import_module("torch_em_tpu_torch.shallow2deep.prepare_shallow2deep")
    raw, labels = s2d_images(seed)
    os.makedirs(out, exist_ok=True)
    digest = hashlib.sha256()
    with tempfile.TemporaryDirectory() as tmp:
        raw_path, label_path = os.path.join(tmp, "raw.npy"), os.path.join(tmp, "labels.npy")
        np.save(raw_path, raw[:TRAIN_IMAGES])
        np.save(label_path, labels[:TRAIN_IMAGES])
        np.random.seed(seed)
        t = time.perf_counter()
        with _digest_of_fits(prepare, digest):
            prepare.prepare_shallow2deep(
                raw_path, None, label_path, None, patch_shape_min=PATCH_MIN, patch_shape_max=PATCH_MAX,
                n_forests=N_FORESTS, n_threads=1, output_folder=os.path.join(tmp, "rfs"), ndim=2,
                label_transform=ForegroundTransform(ndim=2), n_estimators=N_ESTIMATORS, random_state=seed)
        seconds = time.perf_counter() - t
        paths = []
        for i in range(N_FORESTS):
            paths.append(os.path.join(out, f"rf_{i:04d}.npz"))
            for ext in (".npz", ".pkl"):
                shutil.copyfile(os.path.join(tmp, "rfs", f"rf_{i:04d}{ext}"), os.path.join(out, f"rf_{i:04d}{ext}"))
    return paths, digest.hexdigest(), seconds


def check_against_committed(paths) -> dict:
    """For each refitted forest, the arrays in which it differs from the committed one (none when
    they are equal node for node)."""
    return {os.path.basename(p): node_differences(load_forest(p), load_forest(os.path.join(FOREST_DIR,
                                                                                         os.path.basename(p))))
            for p in paths}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-o", "--out", help="write the forests here")
    parser.add_argument("--check", action="store_true", help="compare the refitted forests with the committed ones")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if args.out is None and not args.check:
        parser.error("give -o OUT, --check or both")
    with tempfile.TemporaryDirectory() as tmp:
        paths, digest, seconds = fit_forests(args.out or tmp, args.seed)
        for path in paths:
            forest = load_forest(path)
            print(f"{os.path.basename(path)}: {forest.n_estimators} trees, {len(forest.feature)} nodes, "
                  f"{forest.n_features_in_} features, classes {forest.classes_.tolist()}")
        with open(RECIPE_RECORD) as f:
            recorded = json.load(f)["features_sha256"]
        print(f"prepare_shallow2deep {seconds:.2f} s; features sha256 {digest} "
              f"({'equal to' if digest == recorded else 'unlike'} the recorded {recorded})")
        if args.check:
            differences = check_against_committed(paths)
            print(json.dumps(differences))
            if any(differences.values()):
                sys.exit(1)


if __name__ == "__main__":
    main()
