"""Usiigaci dataset: label-free cell segmentation & tracking in phase
contrast (reference torch_em/data/datasets/light_microscopy/usiigaci.py).

Publication: https://doi.org/10.1016/j.softx.2019.02.007
"""

import os
import subprocess
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util


def get_usiigaci_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Clone the Usiigaci repository (the data ships in-repo)."""
    data_dir = os.path.join(path, "Usiigaci")
    if os.path.exists(data_dir):
        return data_dir
    if not download:
        raise RuntimeError("Cannot find the data; use download=True to clone it.")
    os.makedirs(path, exist_ok=True)
    subprocess.run(["git", "clone", "--quiet", "https://github.com/oist/Usiigaci", data_dir],
                   check=True)
    return data_dir


def get_usiigaci_paths(path: Union[os.PathLike, str], split: str,
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the Usiigaci images and instance labels
    ('train' / 'val')."""
    assert split in ("train", "val"), f"Invalid split: {split}"
    get_usiigaci_data(path, download)
    base_dir = os.path.join(path, "Usiigaci", "Mask R-CNN", split, "set*")
    raw_paths = util.natsorted(glob(os.path.join(base_dir, "raw.tif")))
    label_paths = util.natsorted(glob(os.path.join(base_dir, "instances_ids.png")))
    if split == "train":
        base_dir = os.path.join(path, "Usiigaci", "Mask R-CNN", split)
        raw_paths.extend(util.natsorted(glob(os.path.join(base_dir, "T98G_sample", "*.tif"))))
        label_paths.extend(util.natsorted(
            glob(os.path.join(base_dir, "T98G_sample_mask_avg", "*.png"))))
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_usiigaci_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         split: str, download: bool = False, **kwargs):
    """Get the Usiigaci dataset for cell segmentation."""
    raw_paths, label_paths = get_usiigaci_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_usiigaci_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        batch_size: int, split: str, download: bool = False,
                        **kwargs) -> DataLoader:
    """Get the Usiigaci data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_usiigaci_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
