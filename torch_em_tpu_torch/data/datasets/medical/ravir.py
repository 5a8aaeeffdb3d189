"""RAVIR dataset: retinal artery/vein segmentation in infrared reflectance
imaging (reference torch_em/data/datasets/medical/ravir.py).

Challenge: https://ravir.grand-challenge.org/.
"""

import os
import shutil
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://drive.google.com/uc?export=download&id=1ZlZoSStvE9VCRq3bJiGhQH931EF0h3hh"
CHECKSUM = "b9cc2e84660ab4ebeb583d510bd71057faf596a99ed6d1e27aee361e3a3f1381"


def get_ravir_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the RAVIR data (google drive)."""
    data_dir = os.path.join(path, "RAVIR_Dataset")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "ravir.zip")
    util.download_source_gdrive(zip_path, URL, download, CHECKSUM, download_type="zip")
    util.unzip(zip_path, path)
    # flatten the nested extraction folder, if present
    tmp_dir = os.path.join(path, "RAVIR Dataset")
    if os.path.exists(tmp_dir) and not os.path.exists(data_dir):
        shutil.move(tmp_dir, data_dir)
    return data_dir


def get_ravir_paths(path: Union[os.PathLike, str],
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the RAVIR images and vessel masks."""
    data_dir = get_ravir_data(path, download)
    image_paths = sorted(glob(os.path.join(data_dir, "train", "training_images", "*")))
    gt_paths = sorted(glob(os.path.join(data_dir, "train", "training_masks", "*")))
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_ravir_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                      resize_inputs: bool = False, download: bool = False, **kwargs):
    """Get the RAVIR dataset for artery/vein segmentation."""
    image_paths, gt_paths = get_ravir_paths(path, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_ravir_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     batch_size: int, resize_inputs: bool = False,
                     download: bool = False, **kwargs) -> DataLoader:
    """Get the RAVIR data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_ravir_dataset(path, patch_shape, resize_inputs=resize_inputs,
                           download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
