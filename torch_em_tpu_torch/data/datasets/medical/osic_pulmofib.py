"""OSIC PulmoFib dataset: heart / lung / trachea segmentation in CT
(reference torch_em/data/datasets/medical/osic_pulmofib.py).

Images from the OSIC pulmonary fibrosis kaggle competition; segmentations
from https://www.kaggle.com/datasets/sandorkonya/ct-lung-heart-trachea-segmentation.
The DICOM scans are read by the port's own reader (``utils/dicom.py``), with
no pydicom.
"""

import json
import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils import dicom
from ....utils.medical_io import load_nrrd, save_nifti
from .. import util

ORGAN_IDS = {"heart": 1, "lung": 2, "trachea": 3}


def get_osic_pulmofib_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the OSIC PulmoFib images and segmentations (kaggle)."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(path, "osic-pulmonary-fibrosis-progression", download,
                                competition=True)
    util.unzip(os.path.join(path, "osic-pulmonary-fibrosis-progression.zip"), data_dir,
               remove=False)
    util.download_source_kaggle(path, "sandorkonya/ct-lung-heart-trachea-segmentation",
                                download)
    util.unzip(os.path.join(path, "ct-lung-heart-trachea-segmentation.zip"), data_dir)
    return data_dir


def _preprocess_inputs(data_dir, split):
    image_dir = os.path.join(data_dir, "preprocessed", "images")
    gt_dir = os.path.join(data_dir, "preprocessed", "ground_truth")
    os.makedirs(image_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    cpath = os.path.join(data_dir, "preprocessed", "confirmer.json")
    completed = os.path.exists(cpath)

    image_paths, gt_paths = [], []
    for uid_path in util.natsorted(glob(os.path.join(data_dir, "train", "*"))):
        uid = os.path.basename(uid_path)
        image_path = os.path.join(image_dir, f"{uid}.nii.gz")
        gt_path = os.path.join(gt_dir, f"{uid}.nii.gz")
        if completed:
            if os.path.exists(image_path) and os.path.exists(gt_path):
                image_paths.append(image_path)
                gt_paths.append(gt_path)
            continue
        all_slices = np.stack([
            dicom.dcmread(p).pixel_array
            for p in util.natsorted(glob(os.path.join(uid_path, "*.dcm")))
        ]).transpose(1, 2, 0)
        all_gt = np.zeros(all_slices.shape, dtype="uint8")
        for ann_path in glob(os.path.join(data_dir, "*", "*", f"{uid}_*.nrrd")):
            ann_organ = Path(ann_path).stem.split("_")[-1]
            if ann_organ == "noisy":
                continue
            per_gt = np.asarray(load_nrrd(ann_path)).transpose(1, 0, 2)
            if per_gt.shape == all_slices.shape:
                all_gt[per_gt > 0] = ORGAN_IDS[ann_organ]
        if len(np.unique(all_gt)) > 1:
            all_gt = np.flip(all_gt, axis=2)
            save_nifti(image_path, all_slices)
            save_nifti(gt_path, np.ascontiguousarray(all_gt))
            image_paths.append(image_path)
            gt_paths.append(gt_path)
    if not completed:
        with open(cpath, "w") as f:
            json.dump("preprocessed", f)
    if split == "train":
        return image_paths[:75], gt_paths[:75]
    if split == "val":
        return image_paths[75:90], gt_paths[75:90]
    if split == "test":
        return image_paths[90:], gt_paths[90:]
    raise ValueError(f"'{split}' is not a valid split.")


def get_osic_pulmofib_paths(path: Union[os.PathLike, str], split: str,
                            download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the OSIC PulmoFib volumes (75/15/rest split)."""
    data_dir = get_osic_pulmofib_data(path, download)
    return _preprocess_inputs(data_dir, split)


def get_osic_pulmofib_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                              split: str, download: bool = False, **kwargs):
    """Get the OSIC PulmoFib dataset for organ segmentation."""
    image_paths, gt_paths = get_osic_pulmofib_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_osic_pulmofib_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                             batch_size: int, split: str, download: bool = False,
                             **kwargs) -> DataLoader:
    """Get the OSIC PulmoFib data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_osic_pulmofib_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
