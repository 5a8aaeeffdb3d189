"""Kvasir-SEG dataset: polyp segmentation in colonoscopy images
(reference torch_em/data/datasets/medical/kvasir.py).

Located at https://datasets.simula.no/kvasir-seg/.
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = "https://datasets.simula.no/downloads/kvasir-seg.zip"
CHECKSUM = "03b30e21d584e04facf49397a2576738fd626815771afbbf788f74a7153478f7"


def get_kvasir_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the Kvasir-SEG data."""
    data_dir = os.path.join(path, "Kvasir-SEG")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "kvasir-seg.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_kvasir_paths(path: Union[os.PathLike, str],
                     download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the Kvasir images and (binarized) polyp masks."""
    Image = _pil_image()

    data_dir = get_kvasir_data(path, download)
    image_paths = sorted(glob(os.path.join(data_dir, "images", "*.jpg")))
    gt_paths = sorted(glob(os.path.join(data_dir, "masks", "*.jpg")))

    neu_gt_dir = os.path.join(data_dir, "masks", "preprocessed")
    os.makedirs(neu_gt_dir, exist_ok=True)
    neu_gt_paths = []
    for gt_path in gt_paths:
        neu_gt_path = os.path.join(neu_gt_dir, f"{Path(gt_path).stem}.tif")
        neu_gt_paths.append(neu_gt_path)
        if os.path.exists(neu_gt_path):
            continue
        gt = np.mean(np.asarray(load_image(gt_path)), axis=-1)
        Image.fromarray((gt >= 240).astype("uint8")).save(neu_gt_path)
    return image_paths, neu_gt_paths


def get_kvasir_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                       resize_inputs: bool = False, download: bool = False, **kwargs):
    """Get the Kvasir-SEG dataset for polyp segmentation."""
    image_paths, gt_paths = get_kvasir_paths(path, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_kvasir_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                      batch_size: int, resize_inputs: bool = False,
                      download: bool = False, **kwargs) -> DataLoader:
    """Get the Kvasir-SEG data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_kvasir_dataset(path, patch_shape, resize_inputs=resize_inputs,
                            download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
