"""PLETHORA dataset: thoracic organ and pleural effusion annotations in CT
(reference torch_em/data/datasets/medical/plethora.py).

Publication: https://doi.org/10.1002/mp.14424. Images are NSCLC-Radiomics CTs
fetched via a TCIA manifest; ground truth is nifti per task ('thoracic' /
'pleural_effusion'). The DICOM series are read by the port's own reader
(``utils/dicom.py``), with no pydicom.
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union
from urllib.parse import urljoin

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils import dicom
from ....utils.medical_io import load_nifti, save_nifti
from .. import util

BASE_URL = "https://wiki.cancerimagingarchive.net/download/attachments/68551327/"

URL = {
    "image": urljoin(BASE_URL, "NSCLC-Radiomics-OriginalCTs.tcia"),
    "gt": {
        "thoracic": urljoin(
            BASE_URL, "PleThora%20Thoracic_Cavities%20June%202020.zip?version=1&modificationDate=1593202695428&api=v2"
        ),
        "pleural_effusion": urljoin(
            BASE_URL, "PleThora%20Effusions%20June%202020.zip?version=1&modificationDate=1593202778373&api=v2"
        ),
    },
}

CHECKSUMS = {
    "image": None,
    "gt": {
        "thoracic": "6dfcb60e46c7b0ccf240bc5d13acb1c45c8d2f4922223f7b2fbd5e37acff2be0",
        "pleural_effusion": "5dd07c327fb5723c5bbb48f2a02d7f365513d3ad136811fbe4def330ef2d7f6a",
    },
}

ZIPFILES = {"thoracic": "thoracic.zip", "pleural_effusion": "pleural_effusion.zip"}


def get_plethora_data(path: Union[os.PathLike, str], task: str,
                      download: bool = False) -> Tuple[str, str, str]:
    """Download the PLETHORA images (TCIA manifest) + task ground truth."""
    image_dir = os.path.join(str(path), "data", "images")
    gt_dir = os.path.join(str(path), "data", "gt",
                          "Thoracic_Cavities" if task == "thoracic" else "Effusions")
    csv_path = os.path.join(str(path), "plethora_images")
    if os.path.exists(image_dir) and os.path.exists(gt_dir):
        return image_dir, gt_dir, str(Path(csv_path).with_suffix(".csv"))

    os.makedirs(str(path), exist_ok=True)

    tcia_path = os.path.join(str(path), "NSCLC-Radiomics-OriginalCTs.tcia")
    util.download_source_tcia(path=tcia_path, url=URL["image"], dst=image_dir,
                              csv_filename=csv_path, download=download)

    zip_path = os.path.join(str(path), ZIPFILES[task])
    util.download_source(path=zip_path, url=URL["gt"][task], download=download,
                         checksum=CHECKSUMS["gt"][task])
    util.unzip(zip_path=zip_path, dst=os.path.join(str(path), "data", "gt"))

    return image_dir, gt_dir, str(Path(csv_path).with_suffix(".csv"))


def _assort_plethora_inputs(image_dir, gt_dir, task, csv_path):
    """Merge per-slice DICOMs into nifti volumes and re-orient the ground
    truth to match (transpose + flips as in the reference)."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    task_gt_dir = os.path.join(gt_dir)

    os.makedirs(os.path.join(image_dir, "preprocessed"), exist_ok=True)
    os.makedirs(os.path.join(task_gt_dir, "preprocessed"), exist_ok=True)

    image_paths, gt_paths = [], []
    for series_uid_dir in glob(os.path.join(image_dir, "1.3*")):
        series_uid = os.path.split(series_uid_dir)[-1]
        subject_id = pd.Series.to_string(df.loc[df["Series UID"] == series_uid]["Subject ID"])[-9:]

        try:
            gt_path = glob(os.path.join(task_gt_dir, subject_id, "*.nii.gz"))[0]
        except IndexError:
            # some patients do not have "Thoracic_Cavities" segmentation
            print(f"The ground truth is missing for subject '{subject_id}'")
            continue

        vol_path = os.path.join(image_dir, "preprocessed", f"{subject_id}.nii.gz")
        neu_gt_path = os.path.join(task_gt_dir, "preprocessed", os.path.split(gt_path)[-1])
        image_paths.append(vol_path)
        gt_paths.append(neu_gt_path)
        if os.path.exists(vol_path) and os.path.exists(neu_gt_path):
            continue

        if not os.path.exists(vol_path):
            all_slices = [dicom.dcmread(p).pixel_array
                          for p in util.natsorted(glob(os.path.join(series_uid_dir, "*.dcm")))]
            volume = np.stack(all_slices).transpose(1, 2, 0)
            save_nifti(vol_path, volume, affine=np.eye(4))

        gt = load_nifti(gt_path)
        gt = gt.transpose(2, 1, 0)  # align w.r.t. the inputs
        gt = np.flip(gt, axis=(0, 1))
        gt = gt.transpose(1, 2, 0)
        save_nifti(neu_gt_path, np.ascontiguousarray(gt), affine=np.eye(4))

    return image_paths, gt_paths


def get_plethora_paths(path: Union[os.PathLike, str], task: str,
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Paired (image, ground truth) nifti paths for a task."""
    image_dir, gt_dir, csv_path = get_plethora_data(path, task, download)
    return _assort_plethora_inputs(image_dir=image_dir, gt_dir=gt_dir, task=task, csv_path=csv_path)


def get_plethora_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                         task: str, resize_inputs: bool = False,
                         download: bool = False, **kwargs):
    """Dataset for thoracic organ / pleural effusion segmentation in CT."""
    image_paths, gt_paths = get_plethora_paths(path, task, download)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs=kwargs, patch_shape=patch_shape, resize_inputs=resize_inputs,
            resize_kwargs=resize_kwargs)
    return default_segmentation_dataset(
        raw_paths=image_paths, raw_key="data",
        label_paths=gt_paths, label_key="data",
        patch_shape=patch_shape, **kwargs,
    )


def get_plethora_loader(path: Union[os.PathLike, str], batch_size: int,
                        patch_shape: Tuple[int, ...], task: str,
                        resize_inputs: bool = False, download: bool = False,
                        **kwargs) -> DataLoader:
    """DataLoader for thoracic organ / pleural effusion segmentation in CT."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_plethora_dataset(path, patch_shape, task, resize_inputs, download, **ds_kwargs)
    return get_data_loader(ds, batch_size, **loader_kwargs)
