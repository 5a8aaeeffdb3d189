"""CHAOS dataset: abdominal organ segmentation in CT and MRI
(reference torch_em/data/datasets/medical/chaos.py).

Located at https://zenodo.org/records/3431873; the DICOM slices are read by
the port's own reader (``utils/dicom.py``), with no pydicom.
"""

import os
from glob import glob
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils import dicom
from ....utils.io import load_image
from ....utils.medical_io import save_nifti
from .. import util

URL = {
    "train": "https://zenodo.org/records/3431873/files/CHAOS_Train_Sets.zip",
    "test": "https://zenodo.org/records/3431873/files/CHAOS_Test_Sets.zip",
}
CHECKSUM = {
    "train": "535f7d3417a0e0f0d9133fb3d962423d2a9cf3f103e4f09a3d8a1daf87d5d2fc",
    "test": "80e9e4d4c4e363f142de4570e9b698e3f92dcb5140cc25a9c1cf4963e5ae7541",
}


def get_chaos_data(path: Union[os.PathLike, str], split: str = "train",
                   download: bool = False) -> str:
    """Download the CHAOS data (only 'train' carries annotations)."""
    assert split == "train", "'train' is the only split with ground truth annotations."
    data_dir = os.path.join(path, "data", "Train_Sets")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, f"chaos_{split}.zip")
    util.download_source(zip_path, URL[split], download, CHECKSUM[split])
    util.unzip(zip_path, os.path.join(path, "data"))
    return data_dir


def _open_image(input_path):
    if os.path.splitext(input_path)[-1] == ".dcm":
        return dicom.dcmread(input_path).pixel_array
    return np.asarray(load_image(input_path))


def _preprocess_inputs(data_dir, modality):
    image_paths, gt_paths = [], []
    for m in modality:
        if m.upper() == "CT":
            m = "CT"
            image_exts, gt_exts = ["DICOM_anon/*"], ["Ground/*"]
        elif m.upper().startswith("MR"):
            m = "MR"
            image_exts = ["T1DUAL/DICOM_anon/InPhase/*", "T2SPIR/DICOM_anon/*"]
            gt_exts = ["T1DUAL/Ground/*", "T2SPIR/Ground/*"]
        else:
            raise ValueError(f"Invalid modality: {m}")
        for uid in glob(os.path.join(data_dir, m, "*")):
            _id = os.path.split(uid)[-1]
            base_dir = os.path.join(data_dir, "preprocessed", m.upper())
            os.makedirs(os.path.join(base_dir, "image"), exist_ok=True)
            os.makedirs(os.path.join(base_dir, "ground_truth"), exist_ok=True)
            for image_ext, gt_ext in zip(image_exts, gt_exts):
                modname = image_ext.split("/")[0] + "_MR" if m == "MR" else m
                image_path = os.path.join(base_dir, "image", f"{_id}_{modname}.nii.gz")
                gt_path = os.path.join(base_dir, "ground_truth", f"{_id}_{modname}.nii.gz")
                image_paths.append(image_path)
                gt_paths.append(gt_path)
                if os.path.exists(image_path) and os.path.exists(gt_path):
                    continue
                raw = np.stack([_open_image(p) for p in
                                util.natsorted(glob(os.path.join(uid, image_ext)))])
                gt = np.stack([_open_image(p) for p in
                               util.natsorted(glob(os.path.join(uid, gt_ext)))]).astype("uint8")
                save_nifti(image_path, raw.transpose(1, 2, 0))
                save_nifti(gt_path, gt.transpose(1, 2, 0))
    return image_paths, gt_paths


def get_chaos_paths(path: Union[os.PathLike, str], split: str = "train",
                    modality: Optional[Union[str, Sequence[str]]] = None,
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the CHAOS volumes (modality 'CT', 'MRI' or both)."""
    data_dir = get_chaos_data(path, split, download)
    if modality is None:
        modality = ["CT", "MRI"]
    elif isinstance(modality, str):
        modality = [modality]
    return _preprocess_inputs(data_dir, modality)


def get_chaos_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                      split: str = "train",
                      modality: Optional[Union[str, Sequence[str]]] = None,
                      download: bool = False, **kwargs):
    """Get the CHAOS dataset for abdominal organ segmentation."""
    image_paths, gt_paths = get_chaos_paths(path, split, modality, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_chaos_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                     batch_size: int, split: str = "train",
                     modality: Optional[Union[str, Sequence[str]]] = None,
                     download: bool = False, **kwargs) -> DataLoader:
    """Get the CHAOS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_chaos_dataset(path, patch_shape, split=split, modality=modality,
                           download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
