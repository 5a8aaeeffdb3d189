"""MicroUSP dataset: prostate segmentation in micro-ultrasound
(reference torch_em/data/datasets/medical/micro_usp.py).

Publication: https://doi.org/10.1016/j.compmedimag.2024.102326
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = ("https://zenodo.org/records/10475293/files/"
       "Micro_Ultrasound_Prostate_Segmentation_Dataset.zip")
CHECKSUM = "031645dc30948314e379d0a0a7d54bad1cd4e1f3f918b77455d69810aa05dce3"


def get_micro_usp_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the MicroUSP data."""
    fname = Path(URL).stem
    data_dir = os.path.join(path, fname)
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, f"{fname}.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_micro_usp_paths(path: Union[os.PathLike, str], split: str,
                        download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the MicroUSP volumes; train is split 85/15 into
    train/val, test is the published test set."""
    data_dir = get_micro_usp_data(path, download)
    if split == "test":
        image_paths = util.natsorted(
            glob(os.path.join(data_dir, split, "micro_ultrasound_scans", "*.nii.gz")))
        gt_paths = util.natsorted(
            glob(os.path.join(data_dir, split, "expert_annotations", "*.nii.gz")))
    else:
        image_paths = util.natsorted(
            glob(os.path.join(data_dir, "train", "micro_ultrasound_scans", "*.nii.gz")))
        gt_paths = util.natsorted(
            glob(os.path.join(data_dir, "train", "expert_annotations", "*.nii.gz")))
        n_val = max(1, int(0.15 * len(image_paths)))
        if split == "train":
            image_paths, gt_paths = image_paths[:-n_val], gt_paths[:-n_val]
        elif split == "val":
            image_paths, gt_paths = image_paths[-n_val:], gt_paths[-n_val:]
        else:
            raise ValueError(f"'{split}' is not a valid split.")
    assert len(image_paths) == len(gt_paths) and len(image_paths) > 0
    return image_paths, gt_paths


def get_micro_usp_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                          split: str, resize_inputs: bool = False,
                          download: bool = False, **kwargs):
    """Get the MicroUSP dataset for prostate segmentation."""
    image_paths, gt_paths = get_micro_usp_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_micro_usp_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                         batch_size: int, split: str, resize_inputs: bool = False,
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the MicroUSP data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_micro_usp_dataset(path, patch_shape, split, resize_inputs=resize_inputs,
                               download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
