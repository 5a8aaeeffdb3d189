"""AMOS dataset: abdominal multi-organ segmentation in CT and MRI
(reference torch_em/data/datasets/medical/amos.py).

Located at https://zenodo.org/records/7155725;
challenge: https://amos22.grand-challenge.org/
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/7155725/files/amos22.zip"
CHECKSUM = "d2fbf2c31abba9824d183f05741ce187b17905b8cca64d1078eabf1ba96775c2"


def get_amos_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the AMOS data."""
    data_dir = os.path.join(path, "amos22")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "amos22.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_amos_paths(path: Union[os.PathLike, str], split: str,
                   modality: Optional[str] = None,
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the AMOS volumes (patient ids < 500 are CT, >= 500 MRI)."""
    data_dir = get_amos_data(path, download)
    dirs = {"train": ("imagesTr", "labelsTr"), "val": ("imagesVa", "labelsVa"),
            "test": ("imagesTs", "labelsTs")}
    if split not in dirs:
        raise ValueError(f"'{split}' is not a valid split.")
    im_dir, gt_dir = dirs[split]
    image_paths = sorted(glob(os.path.join(data_dir, im_dir, "*.nii.gz")))
    gt_paths = sorted(glob(os.path.join(data_dir, gt_dir, "*.nii.gz")))
    if modality is not None:
        keep_ct = modality.upper() == "CT"
        if modality.upper() not in ("CT", "MRI"):
            raise ValueError(f"'{modality}' is not a valid modality.")
        pairs = [
            (ip, gp) for ip, gp in zip(image_paths, gt_paths)
            if (int(Path(ip.split(".")[0]).stem.split("_")[-1]) < 500) == keep_ct
        ]
        image_paths = [p[0] for p in pairs]
        gt_paths = [p[1] for p in pairs]
    return image_paths, gt_paths


def get_amos_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                     split: str, modality: Optional[str] = None,
                     download: bool = False, **kwargs):
    """Get the AMOS dataset for multi-organ segmentation."""
    image_paths, gt_paths = get_amos_paths(path, split, modality, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_amos_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                    batch_size: int, split: str, modality: Optional[str] = None,
                    download: bool = False, **kwargs) -> DataLoader:
    """Get the AMOS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_amos_dataset(path, patch_shape, split, modality=modality,
                          download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
