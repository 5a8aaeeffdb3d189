"""BBBC030 dataset: CHO cell segmentation in DIC microscopy
(reference torch_em/data/datasets/light_microscopy/bbbc030.py).

From the Broad Bioimage Benchmark Collection,
https://bbbc.broadinstitute.org/BBBC030.
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

IMAGE_URL = "https://data.broadinstitute.org/bbbc/BBBC030/images.zip"
GT_URL = "https://data.broadinstitute.org/bbbc/BBBC030/ground_truth.zip"


def _contours_to_instances(contour_mask):
    """Convert hand-drawn boundary contours to instances: dilate the
    boundaries to close gaps, label the enclosed interiors, drop the largest
    (background) component."""
    from scipy.ndimage import binary_dilation

    from ....ops.host import connected_components

    closed = binary_dilation(contour_mask > 0, iterations=2)
    labeled = connected_components(~closed)
    counts = np.bincount(labeled.ravel())
    if len(counts) <= 1:
        return np.zeros_like(contour_mask, dtype=np.int32)
    counts[0] = 0
    bg_label = int(np.argmax(counts))
    labeled[labeled == bg_label] = 0
    return labeled.astype(np.int32)


def _preprocess(data_dir):
    h5py = _h5py()

    h5_dir = os.path.join(data_dir, "h5_data")
    if os.path.exists(h5_dir):
        return h5_dir
    os.makedirs(h5_dir, exist_ok=True)
    for raw_path in util.natsorted(glob(os.path.join(data_dir, "images", "*.png"))):
        fname = os.path.splitext(os.path.basename(raw_path))[0]
        gt_path = os.path.join(data_dir, "ground_truth", os.path.basename(raw_path))
        if not os.path.exists(gt_path):
            continue
        raw = np.asarray(load_image(raw_path))
        if raw.ndim == 3:
            raw = raw[..., 0]
        instances = _contours_to_instances(np.asarray(load_image(gt_path)))
        with h5py.File(os.path.join(h5_dir, fname + ".h5"), "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=instances, compression="gzip")
    return h5_dir


def get_bbbc030_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the BBBC030 data."""
    h5_dir = os.path.join(path, "h5_data")
    if os.path.exists(h5_dir):
        return h5_dir
    os.makedirs(path, exist_ok=True)
    img_zip = os.path.join(path, "images.zip")
    gt_zip = os.path.join(path, "ground_truth.zip")
    util.download_source(img_zip, IMAGE_URL, download, checksum=None)
    util.download_source(gt_zip, GT_URL, download, checksum=None)
    util.unzip(img_zip, path)
    util.unzip(gt_zip, path)
    return _preprocess(path)


def get_bbbc030_paths(path: Union[os.PathLike, str], download: bool = False) -> List[str]:
    """Get paths to the BBBC030 volumes."""
    h5_dir = get_bbbc030_data(path, download)
    return util.natsorted(glob(os.path.join(h5_dir, "*.h5")))


def get_bbbc030_dataset(path: Union[os.PathLike, str], patch_shape,
                        download: bool = False, **kwargs):
    """Get the BBBC030 dataset for cell segmentation."""
    paths = get_bbbc030_paths(path, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape,
                                        ndim=2, **kwargs)


def get_bbbc030_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                       download: bool = False, **kwargs) -> DataLoader:
    """Get the BBBC030 data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_bbbc030_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
