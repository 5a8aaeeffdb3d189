"""NISNet3D dataset: 3D nucleus segmentation in cleared-tissue fluorescence
volumes (reference torch_em/data/datasets/light_microscopy/nisnet3d.py).

Located at https://zenodo.org/records/7065147.
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/7065147/files/ground_truth_and_synthetic.zip"
CHECKSUM = "02f8ad4a6e489283548ea4f0c2c39ac975531c09b58e4d6f498b4e49ac73f0d3"

VOLUMES = [
    "BABB-cleared_kidney_1",
    "Cleared_mouse_intestine_1",
    "Diabetic_Biopsy_Human_Spectral_1",
    "Diabetic_Biopsy_Human_Spectral_3",
    "Kidney_Cortex_Human_Spectral_1",
    "Kidney_Human_Nephrectomy_1",
    "Rat_liver_1",
    "Scale-cleared_rat_kidney_1",
]


def get_nisnet3d_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the NISNet3D data."""
    data_dir = os.path.join(path, "ground_truth_and_synthetic")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "ground_truth_and_synthetic.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_nisnet3d_paths(path: Union[os.PathLike, str],
                       volumes: Optional[List[str]] = None,
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the NISNet3D subvolumes (each folder holds {name}.tif and
    {name}_gt.tif; the 'synthetic' subfolders are skipped)."""
    if volumes is None:
        volumes = VOLUMES
    invalid = [v for v in volumes if v not in VOLUMES]
    if invalid:
        raise ValueError(f"Invalid volumes: {invalid}. Valid choices are {VOLUMES}.")
    data_dir = get_nisnet3d_data(path, download)
    raw_paths, label_paths = [], []
    for vol in volumes:
        for sub_dir in util.natsorted(glob(os.path.join(data_dir, vol, "*"))):
            if not os.path.isdir(sub_dir) or os.path.basename(sub_dir) == "synthetic":
                continue
            sub_name = os.path.basename(sub_dir)
            raw_file = os.path.join(sub_dir, f"{sub_name}.tif")
            label_file = os.path.join(sub_dir, f"{sub_name}_gt.tif")
            if os.path.exists(raw_file) and os.path.exists(label_file):
                raw_paths.append(raw_file)
                label_paths.append(label_file)
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_nisnet3d_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                         volumes: Optional[List[str]] = None, download: bool = False,
                         **kwargs):
    """Get the NISNet3D dataset for 3D nucleus segmentation."""
    raw_paths, label_paths = get_nisnet3d_paths(path, volumes, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_nisnet3d_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                        batch_size: int, volumes: Optional[List[str]] = None,
                        download: bool = False, **kwargs) -> DataLoader:
    """Get the NISNet3D data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_nisnet3d_dataset(path, patch_shape, volumes=volumes, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
