"""Duke Liver dataset: liver segmentation in MRI
(reference torch_em/data/datasets/medical/duke_liver.py).

The data must be requested at https://doi.org/10.5281/zenodo.7774566
(Segmentation.zip); the DICOM series are read by the port's own reader
(``utils/dicom.py``), with no pydicom.
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils import dicom
from ....utils.medical_io import save_nifti
from .. import util


def get_duke_liver_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Unpack the manually downloaded Duke Liver zip."""
    data_dir = os.path.join(path, "data", "Segmentation")
    if os.path.exists(data_dir):
        return data_dir
    if download:
        raise NotImplementedError(
            "Automatic download for the Duke Liver dataset is not possible; request it at "
            "https://doi.org/10.5281/zenodo.7774566 and place 'Segmentation.zip' at the path."
        )
    zip_path = os.path.join(path, "Segmentation.zip")
    util.unzip(zip_path, os.path.join(path, "data"), remove=False)
    return data_dir


def _preprocess_data(path, data_dir):
    preprocess_dir = os.path.join(path, "data", "preprocessed")
    if os.path.exists(preprocess_dir):
        return (util.natsorted(glob(os.path.join(preprocess_dir, "images", "*.nii.gz"))),
                util.natsorted(glob(os.path.join(preprocess_dir, "masks", "*.nii.gz"))))

    os.makedirs(os.path.join(preprocess_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(preprocess_dir, "masks"), exist_ok=True)

    image_paths, gt_paths = [], []
    for patient_dir in glob(os.path.join(data_dir, "00*")):
        patient_id = os.path.split(patient_dir)[-1]
        for sub_id_dir in glob(os.path.join(patient_dir, "*")):
            sub_id = os.path.split(sub_id_dir)[-1]
            image_path = os.path.join(preprocess_dir, "images", f"{patient_id}_{sub_id}.nii.gz")
            gt_path = os.path.join(preprocess_dir, "masks", f"{patient_id}_{sub_id}.nii.gz")
            image_paths.append(image_path)
            gt_paths.append(gt_path)
            if os.path.exists(image_path) and os.path.exists(gt_path):
                continue
            image = np.stack([
                dicom.dcmread(p).pixel_array
                for p in util.natsorted(glob(os.path.join(sub_id_dir, "images", "*.dicom")))
            ], axis=0)
            gt = np.stack([
                dicom.dcmread(p).pixel_array
                for p in util.natsorted(glob(os.path.join(sub_id_dir, "masks", "*.dicom")))
            ], axis=0)
            save_nifti(image_path, image)
            save_nifti(gt_path, gt)
    return image_paths, gt_paths


def get_duke_liver_paths(path: Union[os.PathLike, str],
                         download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the Duke Liver volumes."""
    data_dir = get_duke_liver_data(path, download)
    return _preprocess_data(path, data_dir)


def get_duke_liver_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                           download: bool = False, **kwargs):
    """Get the Duke Liver dataset for liver segmentation."""
    image_paths, gt_paths = get_duke_liver_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_duke_liver_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                          batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the Duke Liver data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_duke_liver_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
