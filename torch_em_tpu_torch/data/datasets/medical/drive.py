"""DRIVE dataset: retinal vessel segmentation in fundus images
(reference torch_em/data/datasets/medical/drive.py).

Challenge: https://drive.grand-challenge.org/;
publication: https://doi.org/10.1109/TMI.2004.825627
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

URL = {
    "train": "https://www.dropbox.com/sh/z4hbbzqai0ilqht/AADp_8oefNFs2bjC2kzl2_Fqa/training.zip?dl=1",
    "test": "https://www.dropbox.com/sh/z4hbbzqai0ilqht/AABuUJQJ5yG5oCuziYzYu8jWa/test.zip?dl=1",
}
CHECKSUM = {
    "train": "7101e19598e2b7aacdbd5e6e7575057b9154a4aaec043e0f4e28902bf4e2e209",
    "test": "d76c95c98a0353487ffb63b3bb2663c00ed1fde7d8fdfd8c3282c6e310a02731",
}


def get_drive_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the DRIVE training data."""
    data_dir = os.path.join(path, "training")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "training.zip")
    util.download_source(zip_path, URL["train"], download, CHECKSUM["train"])
    util.unzip(zip_path, path)
    return data_dir


def _get_drive_ground_truth(data_dir):
    """Convert the gif vessel annotations to binary tif masks."""
    Image = _pil_image()

    neu_gt_dir = os.path.join(data_dir, "gt")
    if os.path.exists(neu_gt_dir):
        return sorted(glob(os.path.join(neu_gt_dir, "*.tif")))
    os.makedirs(neu_gt_dir, exist_ok=True)
    neu_gt_paths = []
    for gt_path in sorted(glob(os.path.join(data_dir, "1st_manual", "*.gif"))):
        gt = np.asarray(load_image(gt_path)).squeeze()
        neu_gt_path = os.path.join(neu_gt_dir, Path(os.path.split(gt_path)[-1]).stem + ".tif")
        Image.fromarray((gt > 0).astype("uint8")).save(neu_gt_path)
        neu_gt_paths.append(neu_gt_path)
    return neu_gt_paths


def get_drive_paths(path: Union[os.PathLike, str], split: str,
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the DRIVE images and vessel masks; the published training
    set is split 10/4/6 into train/val/test."""
    data_dir = get_drive_data(path, download)
    image_paths = sorted(glob(os.path.join(data_dir, "images", "*.tif")))
    gt_paths = _get_drive_ground_truth(data_dir)
    if split == "train":
        return image_paths[:10], gt_paths[:10]
    if split == "val":
        return image_paths[10:14], gt_paths[10:14]
    if split == "test":
        return image_paths[14:], gt_paths[14:]
    raise ValueError(f"'{split}' is not a valid split.")


def get_drive_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                      split: str, resize_inputs: bool = False,
                      download: bool = False, **kwargs):
    """Get the DRIVE dataset for retinal vessel segmentation."""
    image_paths, gt_paths = get_drive_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_drive_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     batch_size: int, split: str, resize_inputs: bool = False,
                     download: bool = False, **kwargs) -> DataLoader:
    """Get the DRIVE data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_drive_dataset(path, patch_shape, split, resize_inputs=resize_inputs,
                           download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
