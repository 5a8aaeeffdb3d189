"""AMD-SD dataset: lesion segmentation in OCT B-scans of AMD patients
(reference torch_em/data/datasets/medical/amd_sd.py).

Publication: https://doi.org/10.1038/s41597-024-03844-6
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = "https://springernature.figshare.com/ndownloader/files/48777037"
CHECKSUM = "16793aac36d814e2858362b4a3b9608e6f57120cf2227a81220407571b8fb359"

MAPPING_IDS = {
    (255, 255, 255): 1,  # White: intraretinal fluid (IRF)
    (0, 255, 0): 2,      # Green: epiretinal membrane (ERM)
    (255, 0, 0): 3,      # Red: subretinal fluid (SRF)
    (255, 255, 0): 4,    # Yellow: subretinal hyperreflective material (SHRM)
    (0, 0, 255): 5,      # Blue: pigment epithelial detachment (PED)
}


def _preprocess_data(data_dir):
    """Split the side-by-side image|annotation pngs and convert the RGB
    annotations to semantic label ids."""
    Image = _pil_image()

    for d in glob(os.path.join(data_dir, "images", "*")):
        dname = os.path.basename(d)
        image_dir = os.path.join(data_dir, "preprocessed", dname, "images")
        label_dir = os.path.join(data_dir, "preprocessed", dname, "labels")
        os.makedirs(image_dir, exist_ok=True)
        os.makedirs(label_dir, exist_ok=True)
        for ipath in util.natsorted(glob(os.path.join(d, "*.png"))):
            image = np.asarray(load_image(ipath))
            half = image.shape[1] // 2
            image, label = image[:, :half, :], image[:, half:, :]
            label = (label / 255).round() * 255
            segmentation = np.zeros(label.shape[:2], dtype="uint8")
            for rgb, label_id in MAPPING_IDS.items():
                segmentation[np.all(label == np.array(rgb), axis=-1)] = label_id
            fname = str(Path(os.path.basename(ipath)).with_suffix(".tif"))
            Image.fromarray(image).save(os.path.join(image_dir, fname))
            Image.fromarray(segmentation).save(os.path.join(label_dir, fname))


def get_amd_sd_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the AMD-SD data."""
    data_dir = os.path.join(path, "AMD-SD")
    if os.path.exists(os.path.join(data_dir, "preprocessed")):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "AMD-SD.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    _preprocess_data(data_dir)
    return data_dir


def get_amd_sd_paths(path: Union[os.PathLike, str], split: str,
                     download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the AMD-SD images and labels (patients split
    100 / 15 / rest into train / val / test)."""
    data_dir = get_amd_sd_data(path, download)
    patient_ids = util.natsorted(glob(os.path.join(data_dir, "preprocessed", "*")))
    if split == "train":
        patient_ids = patient_ids[:100]
    elif split == "val":
        patient_ids = patient_ids[100:115]
    elif split == "test":
        patient_ids = patient_ids[115:]
    else:
        raise ValueError(f"'{split}' is not a valid split.")
    raw_paths, label_paths = [], []
    for pid in patient_ids:
        raw_paths.extend(util.natsorted(glob(os.path.join(pid, "images", "*.tif"))))
        label_paths.extend(util.natsorted(glob(os.path.join(pid, "labels", "*.tif"))))
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_amd_sd_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                       split: str, resize_inputs: bool = False,
                       download: bool = False, **kwargs):
    """Get the AMD-SD dataset for OCT lesion segmentation."""
    raw_paths, label_paths = get_amd_sd_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_amd_sd_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                      batch_size: int, split: str, resize_inputs: bool = False,
                      download: bool = False, **kwargs) -> DataLoader:
    """Get the AMD-SD data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_amd_sd_dataset(path, patch_shape, split, resize_inputs=resize_inputs,
                            download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
