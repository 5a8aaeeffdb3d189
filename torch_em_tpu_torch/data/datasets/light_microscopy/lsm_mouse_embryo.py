"""LSM Mouse Embryo dataset: tissue and cell segmentation in light-sheet
microscopy of mouse embryos (reference
torch_em/data/datasets/light_microscopy/lsm_mouse_embryo.py).

From the publication https://doi.org/10.1109/ACCESS.2022.3210542.
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = "https://www.dropbox.com/s/7zkk4j415ncfs47/LSM_Segmentation_Dataset.zip?dl=1"
TASKS = {
    "tissue": {"dir": "DAPI-Tissue", "mask_dir": "Mask"},
    "cells": {"dir": "DAPI-Cells", "mask_dir": "Mesen_Mask"},
    "proliferating_cells": {"dir": "PHH3-Cells", "mask_dir": "Mask"},
}
_SPLIT_MAPPING = {"train": "Training", "val": "Validation", "test": "Test"}


def _preprocess_masks(mask_dir, processed_dir):
    """Normalize masks (some ship as RGBA pngs) to single-channel uint8 tifs."""
    Image = _pil_image()
    os.makedirs(processed_dir, exist_ok=True)
    for mask_path in util.natsorted(glob(os.path.join(mask_dir, "*.png"))):
        out_path = os.path.join(
            processed_dir, os.path.basename(mask_path).replace(".png", ".tif"))
        if os.path.exists(out_path):
            continue
        mask = np.asarray(load_image(mask_path))
        if mask.ndim == 3:
            mask = mask[..., 0] > 0
        Image.fromarray(np.asarray(mask, dtype="uint8")).save(out_path)


def get_lsm_mouse_embryo_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the LSM mouse embryo data."""
    data_dir = os.path.join(path, "LSM_Segmentation_Dataset")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "LSM_Segmentation_Dataset.zip")
    util.download_source(zip_path, URL, download)
    util.unzip(zip_path, path)
    return data_dir


def get_lsm_mouse_embryo_paths(path: Union[os.PathLike, str], split: str = "train",
                               task: str = "tissue",
                               download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the LSM mouse embryo images and masks."""
    assert split in _SPLIT_MAPPING, f"'{split}' is not a valid split."
    assert task in TASKS, f"'{task}' is not a valid task."
    data_dir = get_lsm_mouse_embryo_data(path, download)
    split_name = _SPLIT_MAPPING[split]
    task_info = TASKS[task]
    image_dir = os.path.join(data_dir, task_info["dir"], split_name, "Original")
    mask_dir = os.path.join(data_dir, task_info["dir"], split_name, task_info["mask_dir"])
    image_paths = util.natsorted(glob(os.path.join(image_dir, "*.png")))
    processed_dir = os.path.join(path, "processed_masks", task, split_name)
    if not os.path.exists(processed_dir) or len(glob(os.path.join(processed_dir, "*.tif"))) == 0:
        _preprocess_masks(mask_dir, processed_dir)
    seg_paths = util.natsorted(glob(os.path.join(processed_dir, "*.tif")))
    assert len(image_paths) == len(seg_paths) and len(image_paths) > 0
    return image_paths, seg_paths


def get_lsm_mouse_embryo_dataset(path: Union[os.PathLike, str],
                                 patch_shape: Tuple[int, int], split: str = "train",
                                 task: str = "tissue", download: bool = False, **kwargs):
    """Get the LSM mouse embryo dataset for tissue and cell segmentation."""
    image_paths, seg_paths = get_lsm_mouse_embryo_paths(path, split, task, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(
        image_paths, None, seg_paths, None, patch_shape,
        is_seg_dataset=False, ndim=2, **kwargs,
    )


def get_lsm_mouse_embryo_loader(path: Union[os.PathLike, str],
                                patch_shape: Tuple[int, int], batch_size: int,
                                split: str = "train", task: str = "tissue",
                                download: bool = False, **kwargs) -> DataLoader:
    """Get the LSM mouse embryo data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_lsm_mouse_embryo_dataset(path, patch_shape, split=split, task=task,
                                      download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
