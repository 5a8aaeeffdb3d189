"""SIIM-ACR dataset: pneumothorax segmentation in chest X-rays
(reference torch_em/data/datasets/medical/siim_acr.py).

Located at
https://www.kaggle.com/datasets/vbookshelf/pneumothorax-chest-xray-images-and-masks;
challenge: https://kaggle.com/competitions/siim-acr-pneumothorax-segmentation
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import load_image
from .. import util

KAGGLE_DATASET_NAME = "vbookshelf/pneumothorax-chest-xray-images-and-masks"
CHECKSUM = "1ade68d31adb996c531bb686fb9d02fe11876ddf6f25594ab725e18c69d81538"


def get_siim_acr_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the SIIM-ACR data (kaggle)."""
    data_dir = os.path.join(path, "siim-acr-pneumothorax")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(path, KAGGLE_DATASET_NAME, download)
    zip_path = os.path.join(path, "pneumothorax-chest-xray-images-and-masks.zip")
    util._check_checksum(zip_path, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def _clean_image_and_label_paths(image_paths, gt_paths):
    """Keep only pairs whose mask has both classes (valid annotations)."""
    def has_multiple_classes(gt_path):
        gt = np.asarray(load_image(gt_path))
        return np.any(gt) and not np.all(gt)

    paths = [(ip, gp) for ip, gp in zip(image_paths, gt_paths) if has_multiple_classes(gp)]
    return [p[0] for p in paths], [p[1] for p in paths]


def get_siim_acr_paths(path: Union[os.PathLike, str], split: str,
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the SIIM-ACR images and masks; the published train split
    is re-split 400/rest into val/train."""
    data_dir = get_siim_acr_data(path, download)
    if split == "test":
        image_paths = util.natsorted(glob(os.path.join(data_dir, "png_images", "*_test_*.png")))
        gt_paths = util.natsorted(glob(os.path.join(data_dir, "png_masks", "*_test_*.png")))
        image_paths, gt_paths = _clean_image_and_label_paths(image_paths, gt_paths)
    else:
        image_paths = util.natsorted(glob(os.path.join(data_dir, "png_images", "*_train_*.png")))
        gt_paths = util.natsorted(glob(os.path.join(data_dir, "png_masks", "*_train_*.png")))
        image_paths, gt_paths = _clean_image_and_label_paths(image_paths, gt_paths)
        if split == "train":
            image_paths, gt_paths = image_paths[400:], gt_paths[400:]
        elif split == "val":
            image_paths, gt_paths = image_paths[:400], gt_paths[:400]
        else:
            raise ValueError(f"'{split}' is not a valid split.")
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_siim_acr_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         split: str, resize_inputs: bool = False,
                         download: bool = False, **kwargs):
    """Get the SIIM-ACR dataset for pneumothorax segmentation."""
    image_paths, gt_paths = get_siim_acr_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_siim_acr_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        batch_size: int, split: str, resize_inputs: bool = False,
                        download: bool = False, **kwargs) -> DataLoader:
    """Get the SIIM-ACR data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_siim_acr_dataset(path, patch_shape, split, resize_inputs=resize_inputs,
                              download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
