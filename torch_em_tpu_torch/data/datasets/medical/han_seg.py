"""HaN-Seg dataset: head & neck organ-at-risk segmentation in CT
(reference torch_em/data/datasets/medical/han_seg.py).

Located at https://zenodo.org/records/7442914.
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.medical_io import load_nrrd, save_nifti
from .. import util

URL = "https://zenodo.org/records/7442914/files/HaN-Seg.zip"
CHECKSUM = "20226dd717f334dc1b1afe961b3375f946fa56b64a80bf5349128f90c0bbfa5f"


def get_han_seg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the HaN-Seg data."""
    data_dir = os.path.join(path, "HaN-Seg")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "HaN-Seg.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_han_seg_paths(path: Union[os.PathLike, str],
                      download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the HaN-Seg CT volumes and merged organ labels (the
    per-organ nrrd masks are combined into one multi-class nifti; MR volumes
    are skipped)."""
    data_dir = get_han_seg_data(path, download)
    image_dir = os.path.join(data_dir, "set_1", "preprocessed", "images")
    gt_dir = os.path.join(data_dir, "set_1", "preprocessed", "ground_truth")
    os.makedirs(image_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    image_paths, gt_paths = [], []
    for case_dir in util.natsorted(glob(os.path.join(data_dir, "set_1", "case_*"))):
        case = os.path.split(case_dir)[-1]
        image_path = os.path.join(image_dir, f"{case}_ct.nii.gz")
        gt_path = os.path.join(gt_dir, f"{case}.nii.gz")
        image_paths.append(image_path)
        gt_paths.append(gt_path)
        if os.path.exists(image_path) and os.path.exists(gt_path):
            continue
        volumes = []
        for nrrd_path in util.natsorted(glob(os.path.join(case_dir, "*.nrrd"))):
            if Path(nrrd_path).stem.endswith("_MR_T1"):
                continue
            volumes.append(np.asarray(load_nrrd(nrrd_path)))
        raw = volumes[0]
        save_nifti(image_path, raw)
        gt = np.zeros(raw.shape, dtype="uint8")
        for idx, per_organ in enumerate(volumes[1:], 1):
            gt[per_organ > 0] = idx
        save_nifti(gt_path, gt)
    return image_paths, gt_paths


def get_han_seg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                        download: bool = False, **kwargs):
    """Get the HaN-Seg dataset for organ-at-risk segmentation."""
    image_paths, gt_paths = get_han_seg_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_han_seg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                       batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the HaN-Seg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_han_seg_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
