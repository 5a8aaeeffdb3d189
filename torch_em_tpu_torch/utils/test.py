"""Synthetic test-data fixtures (reference torch_em/util/test.py); the port's
copy of the JAX package's ``utils/test.py``. HDF5 files are written by the port's own
module (``utils/hdf5.py``); PIL is imported inside the function that writes image files
(``utils/io.py``)."""

import os
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from ..ops import native
from ..ops.host import find_boundaries
from .io import _h5py, _pil_image

__all__ = ["make_gt", "make_volume", "make_image", "make_mito_image", "create_segmentation_test_data",
           "create_image_collection_test_data"]


def make_gt(spatial_shape: Sequence[int], n_batches: Optional[int] = None,
            with_channels: bool = False, with_background: bool = False, dtype=None) -> np.ndarray:
    """Realistic instance ground truth via seeded watershed on a smoothed EDT
    (reference util/test.py:14)."""
    def _make_single():
        seeds = np.zeros(spatial_shape, dtype="uint32")
        n_seeds = max(int(np.prod(spatial_shape) // 400), 4)
        coords = tuple(
            np.random.randint(0, s, size=n_seeds) for s in spatial_shape
        )
        seeds[coords] = np.arange(1, n_seeds + 1)
        hmap = ndimage.gaussian_filter(np.random.rand(*spatial_shape).astype("float32"), 2.0)
        gt = native.watershed(hmap, seeds)
        if with_background:
            gt[gt == gt.flat[0]] = 0
        return gt

    gts = []
    n = 1 if n_batches is None else n_batches
    for _ in range(n):
        gt = _make_single()
        if with_channels:
            gt = gt[None]
        gts.append(gt)
    out = gts[0] if n_batches is None else np.stack(gts)
    if dtype is not None:
        out = out.astype(dtype)
    return out


def make_volume(rng: np.random.Generator, shape=(24, 96, 96)):
    """A synthetic CREMI-like EM volume and its neuron-like instance labels, the
    parity probes' data (``experiments/parity/make_data3d.py:20``; ``rng`` seeded with
    13 there): labels are a seeded watershed over noise smoothed anisotropically in z,
    raw shows dark membranes at their boundaries on a textured background, blurred,
    with noise. Returns (raw float32, labels uint32)."""
    shape = tuple(shape)
    n_seeds = max(int(np.prod(shape) // 3000), 8)
    seeds = np.zeros(shape, dtype="uint32")
    coords = tuple(rng.integers(0, s, n_seeds) for s in shape)
    seeds[coords] = np.arange(1, n_seeds + 1)
    hmap = ndimage.gaussian_filter(rng.random(shape, dtype=np.float32), (1.0, 3.0, 3.0))
    labels = native.watershed(hmap, seeds)

    membranes = find_boundaries(labels, mode="thick").astype("float32")
    raw = 0.75 - 0.55 * ndimage.gaussian_filter(membranes, (0.5, 1.0, 1.0))
    raw = raw + 0.08 * ndimage.gaussian_filter(rng.random(shape, dtype=np.float32), 1.0)
    raw = np.clip(raw + rng.normal(0, 0.03, shape), 0, 1).astype("float32")
    return raw, labels.astype("uint32")


def make_image(rng: np.random.Generator, size: int = 128):
    """A synthetic DSB-like nucleus image and its instance labels, the SPOCO probe's data
    (``experiments/parity/make_data.py:make_image``; ``rng`` seeded with 42 there): the
    EDT core of each region of a seeded watershed over smoothed noise becomes a nucleus of
    its own intensity, blurred, with noise. Returns (raw float32 in [0, 1], labels uint32)."""
    shape = (size, size)
    n_seeds = int(rng.integers(10, 20))
    seeds = np.zeros(shape, dtype="uint32")
    coords = (rng.integers(0, size, n_seeds), rng.integers(0, size, n_seeds))
    seeds[coords] = np.arange(1, n_seeds + 1)
    hmap = ndimage.gaussian_filter(rng.random(shape, dtype=np.float32), 2.0)
    ws = native.watershed(hmap, seeds)

    labels = np.zeros(shape, dtype="uint32")
    raw = np.full(shape, 0.08, dtype="float32")
    next_id = 1
    for region_id in np.unique(ws):
        mask = ws == region_id
        edt = ndimage.distance_transform_edt(mask)
        rmax = edt.max()
        if rmax < 3:  # too small to host a nucleus
            continue
        tau = rng.uniform(0.25, 0.55) * rmax
        nucleus = edt > max(tau, 1.5)
        if nucleus.sum() < 12:
            continue
        labels[nucleus] = next_id
        raw[nucleus] = rng.uniform(0.35, 0.95)
        next_id += 1

    raw = ndimage.gaussian_filter(raw, 1.0)
    raw = raw + rng.normal(0.0, 0.04, shape).astype("float32")
    raw = np.clip(raw, 0.0, 1.0).astype("float32")
    return raw, labels


def make_mito_image(rng: np.random.Generator, size: int = 512):
    """A synthetic 2-D EM image with mitochondria and their instance labels, the Shallow2Deep
    recipe's data: a textured background, the dark membranes of the cells of a seeded
    watershed, and elongated blobs (ellipses of random size and orientation, one per 6000
    pixels) with a dark inside and a bright border, blurred, with noise. Returns (raw float32
    in [0, 1], labels uint32)."""
    shape = (size, size)
    n_seeds = max(size * size // 6000, 8)
    seeds = np.zeros(shape, dtype="uint32")
    seeds[rng.integers(0, size, n_seeds), rng.integers(0, size, n_seeds)] = np.arange(1, n_seeds + 1)
    cells = native.watershed(ndimage.gaussian_filter(rng.random(shape, dtype=np.float32), 4.0), seeds)
    membranes = find_boundaries(cells, mode="thick").astype("float32")
    raw = 0.6 + 0.12 * ndimage.gaussian_filter(rng.random(shape, dtype=np.float32), 2.0)
    raw = raw - 0.3 * ndimage.gaussian_filter(membranes, 1.0)

    labels = np.zeros(shape, dtype="uint32")
    for k in range(1, max(size * size // 6000, 4) + 1):
        cy, cx = rng.uniform(0, size, 2)
        a, b, theta = rng.uniform(10.0, 28.0), rng.uniform(5.0, 10.0), rng.uniform(0.0, np.pi)
        y0, y1 = int(max(cy - a - 1, 0)), int(min(cy + a + 2, size))
        x0, x1 = int(max(cx - a - 1, 0)), int(min(cx + a + 2, size))
        yy, xx = np.mgrid[y0:y1, x0:x1]
        u = ((xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)) / a
        v = (-(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)) / b
        r = u * u + v * v
        inside = (r <= 1.0) & (labels[y0:y1, x0:x1] == 0)
        labels[y0:y1, x0:x1][inside] = k
        raw[y0:y1, x0:x1][inside] = np.where(r[inside] > 0.55, 0.9, 0.3)

    raw = ndimage.gaussian_filter(raw.astype("float32"), 1.0) + rng.normal(0.0, 0.04, shape).astype("float32")
    return np.clip(raw, 0.0, 1.0).astype("float32"), labels


def create_segmentation_test_data(data_path: str, raw_key: str, label_key: str,
                                  shape: Tuple[int, ...], chunks: Tuple[int, ...]) -> None:
    """Random h5 raw + randint labels (reference util/test.py:43)."""
    with _h5py().File(data_path, "a") as f:
        f.create_dataset(raw_key, data=np.random.rand(*shape), chunks=chunks)
        f.create_dataset(label_key, data=np.random.randint(0, 4, size=shape), chunks=chunks)


def create_image_collection_test_data(folder: str, n_images: int,
                                      min_shape: Tuple[int, ...], max_shape: Tuple[int, ...]) -> None:
    """Random-shaped image/label pairs (reference util/test.py:49); saved as
    png (tifffile is not a dependency of the package)."""
    Image = _pil_image()

    im_folder = os.path.join(folder, "images")
    label_folder = os.path.join(folder, "labels")
    os.makedirs(im_folder, exist_ok=True)
    os.makedirs(label_folder, exist_ok=True)

    for i in range(n_images):
        shape = tuple(np.random.randint(mins, maxs) for mins, maxs in zip(min_shape, max_shape))
        raw = (np.random.rand(*shape) * 255).astype("uint8")
        label = np.random.randint(0, 4, size=shape).astype("uint8")
        Image.fromarray(raw).save(os.path.join(im_folder, f"im{i}.png"))
        Image.fromarray(label).save(os.path.join(label_folder, f"im{i}.png"))
