"""Fit the Shallow2Deep forests that ``chip_smoke.py`` phase 16 trains its enhancer on.

    python3 scripts/torch_s2d_forests.py            # writes scripts/s2d_forests/rf_XXXX.npz
    python3 scripts/torch_s2d_forests.py -o OUT --seed 0

Needs scikit-learn (the machine with the card has none; the forests are
committed as ``.npz`` files, which the port reads with numpy alone). Steps:

1. Data: the first ``TRAIN_IMAGES`` images of ``s2d_images(seed)``, 512x512
   EM-like images with mitochondria (``utils.test.make_mito_image``), the
   images phase 16 trains the enhancer on, stacked into one (8, 512, 512)
   ``.npy`` volume with its labels in a temporary folder.
2. Forests: ``prepare_shallow2deep`` with ``np.random.seed(seed)``, one
   thread, 4 forests of ``RandomForestClassifier(n_estimators=10,
   random_state=seed)``, each on one patch of 128x128 to 192x192 pixels, the
   default filter bank (28 features in 2-D) and ``ForegroundTransform``
   targets (label balancing on).
3. Export: ``export_forests`` writes each pickle's ``.npz`` beside it, and
   those are copied to ``OUT``; the script checks that each predicts as its
   sklearn forest (atol 1e-12) and prints their nodes and bytes.
"""

import argparse
import os
import pickle
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from torch_em_tpu_torch.shallow2deep import (  # noqa: E402
    ForegroundTransform, export_forests, load_forest, prepare_shallow2deep,
)
from torch_em_tpu_torch.utils.test import make_mito_image  # noqa: E402

TRAIN_IMAGES, TEST_IMAGES, IMAGE_SIZE = 8, 2, 512
N_FORESTS, N_ESTIMATORS = 4, 10
PATCH_MIN, PATCH_MAX = (1, 128, 128), (1, 192, 192)
FOREST_DIR = os.path.join(REPO, "scripts", "s2d_forests")


def s2d_images(seed: int = 0, n: int = TRAIN_IMAGES + TEST_IMAGES, size: int = IMAGE_SIZE):
    """``n`` seeded images and labels of ``make_mito_image``: (n, size, size) float32 and uint32.
    The first ``TRAIN_IMAGES`` fit the forests and train the enhancer, the rest test it."""
    rng = np.random.default_rng(seed)
    raws, labels = zip(*(make_mito_image(rng, size) for _ in range(n)))
    return np.stack(raws), np.stack(labels)


def fit_forests(out: str, seed: int = 0) -> list:
    """Fit the forests with sklearn and write their ``.npz`` files to ``out``; returns the paths."""
    raw, labels = s2d_images(seed)
    os.makedirs(out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        raw_path, label_path = os.path.join(tmp, "raw.npy"), os.path.join(tmp, "labels.npy")
        np.save(raw_path, raw[:TRAIN_IMAGES])
        np.save(label_path, labels[:TRAIN_IMAGES])
        np.random.seed(seed)
        prepare_shallow2deep(raw_path, None, label_path, None, patch_shape_min=PATCH_MIN, patch_shape_max=PATCH_MAX,
                             n_forests=N_FORESTS, n_threads=1, output_folder=os.path.join(tmp, "rfs"), ndim=2,
                             label_transform=ForegroundTransform(ndim=2), n_estimators=N_ESTIMATORS,
                             random_state=seed)
        paths = []
        features = np.random.default_rng(seed).normal(0.5, 0.5, (4096, 28)).astype(np.float32)
        for npz in export_forests(os.path.join(tmp, "rfs")):
            with open(os.path.splitext(npz)[0] + ".pkl", "rb") as f:
                expected = pickle.load(f).predict_proba(features)
            err = float(np.abs(load_forest(npz).predict_proba(features) - expected).max())
            if err > 1e-12:
                raise AssertionError(f"{os.path.basename(npz)} predicts {err} away from its sklearn forest")
            paths.append(os.path.join(out, os.path.basename(npz)))
            shutil.copyfile(npz, paths[-1])
    for path in paths:
        forest = load_forest(path)
        print(f"{os.path.relpath(path, REPO)}: {forest.n_estimators} trees, {len(forest.feature)} nodes, "
              f"{os.path.getsize(path)} bytes, {forest.n_features_in_} features, classes {forest.classes_.tolist()}")
    print(f"total {sum(os.path.getsize(p) for p in paths)} bytes")
    return paths


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-o", "--out", default=FOREST_DIR)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    fit_forests(args.out, args.seed)


if __name__ == "__main__":
    main()
