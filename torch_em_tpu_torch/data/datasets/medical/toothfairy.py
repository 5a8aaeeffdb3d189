"""ToothFairy datasets (v1 / v2): inferior alveolar nerve and multi-structure
segmentation in CBCT (reference
torch_em/data/datasets/medical/toothfairy.py).

The data must be downloaded manually from the challenge platform
(https://toothfairychallenges.github.io/) and placed as a zip at ``path``.
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.medical_io import save_nifti
from .. import util


def get_toothfairy_data(path: Union[os.PathLike, str], version: str = "v2",
                        download: bool = False) -> str:
    """Unpack the manually downloaded ToothFairy zip."""
    data_dir = os.path.join(
        path, "ToothFairy_Dataset/Dataset" if version == "v1" else "Dataset112_ToothFairy2")
    if os.path.exists(data_dir):
        return data_dir
    if download:
        raise NotImplementedError(
            "ToothFairy cannot be downloaded automatically; download the zip from the "
            "challenge platform and place it at the given path."
        )
    if version == "v1":
        zip_path = os.path.join(path, "ToothFairy_Dataset.zip")
    elif version == "v2":
        zip_path = os.path.join(path, "ToothFairy2_Dataset.zip")
    else:
        raise ValueError(f"'{version}' is not a valid version.")
    if not os.path.exists(zip_path):
        raise FileNotFoundError(f"Place the downloaded toothfairy zipfile at '{path}'.")
    util.unzip(zip_path, path, remove=False)
    return data_dir


def _preprocess_toothfairy_inputs(path, data_dir):
    images_dir = os.path.join(path, "data", "images")
    gt_dir = os.path.join(path, "data", "dense_labels")
    if os.path.exists(images_dir) and os.path.exists(gt_dir):
        return (util.natsorted(glob(os.path.join(images_dir, "*.nii.gz"))),
                util.natsorted(glob(os.path.join(gt_dir, "*.nii.gz"))))
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    image_paths, gt_paths = [], []
    for patient_dir in glob(os.path.join(data_dir, "P*")):
        dense_anns_path = os.path.join(patient_dir, "gt_alpha.npy")
        if not os.path.exists(dense_anns_path):
            continue
        patient_id = os.path.split(patient_dir)[-1]
        image_path = os.path.join(images_dir, f"{patient_id}.nii.gz")
        gt_path = os.path.join(gt_dir, f"{patient_id}.nii.gz")
        image_paths.append(image_path)
        gt_paths.append(gt_path)
        if os.path.exists(image_path) and os.path.exists(gt_path):
            continue
        save_nifti(image_path, np.load(os.path.join(patient_dir, "data.npy")))
        save_nifti(gt_path, np.load(dense_anns_path))
    return util.natsorted(image_paths), util.natsorted(gt_paths)


def get_toothfairy_paths(path: Union[os.PathLike, str], split: str,
                         version: str = "v2",
                         download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the ToothFairy volumes with the reference's splits."""
    data_dir = get_toothfairy_data(path, version, download)
    if version == "v1":
        image_paths, gt_paths = _preprocess_toothfairy_inputs(path, data_dir)
        slices = {"train": slice(0, 100), "val": slice(100, 125), "test": slice(125, None)}
    else:
        image_paths = util.natsorted(glob(os.path.join(data_dir, "imagesTr", "*.mha")))
        gt_paths = util.natsorted(glob(os.path.join(data_dir, "labelsTr", "*.mha")))
        slices = {"train": slice(0, 400), "val": slice(400, 425), "test": slice(425, None)}
    if split not in slices:
        raise ValueError(f"'{split}' is not a valid split.")
    s = slices[split]
    return image_paths[s], gt_paths[s]


def get_toothfairy_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                           split: str, version: str = "v2",
                           download: bool = False, **kwargs):
    """Get the ToothFairy dataset."""
    image_paths, gt_paths = get_toothfairy_paths(path, split, version, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_toothfairy_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                          batch_size: int, split: str, version: str = "v2",
                          download: bool = False, **kwargs) -> DataLoader:
    """Get the ToothFairy data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_toothfairy_dataset(path, patch_shape, split, version=version,
                                download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
