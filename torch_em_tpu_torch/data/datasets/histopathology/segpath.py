"""SegPath dataset: semantic segmentation of eight tissue/cell types in H&E
histopathology, with IF-restained masks
(reference torch_em/data/datasets/histopathology/segpath.py).

Hosted across several zenodo records (https://dakomura.github.io/SegPath/).
Image/mask png pairs are converted to h5 with 'images/raw' (CHW) and
'labels/mask'; the per-cell-type fileinfo csv provides the splits.
"""

import csv
import gzip
import os
import tarfile
from glob import glob
from pathlib import Path
from shutil import rmtree
from typing import List, Optional, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URLS = {
    "epithelium": {
        "data": "https://zenodo.org/api/records/7412731/files/panCK_Epithelium.tar.gz/content",
        "metadata": "https://zenodo.org/api/records/7412731/files/panCK_fileinfo.csv/content",
        "data_name": "panCK_Epithelium.tar.gz", "metadata_name": "panCK_fileinfo.csv",
    },
    "smooth_muscle": {
        "data": "https://zenodo.org/api/records/7412732/files/aSMA_SmoothMuscle.tar.gz/content",
        "metadata": "https://zenodo.org/api/records/7412732/files/aSMA_fileinfo.csv/content",
        "data_name": "aSMA_SmoothMuscle.tar.gz", "metadata_name": "aSMA_fileinfo.csv",
    },
    "red_blood_cells": {
        "data": "https://zenodo.org/api/records/7412580/files/CD235a_RBC.tar.gz/content",
        "metadata": "https://zenodo.org/api/records/7412580/files/CD235a_fileinfo.csv/content",
        "data_name": "CD235a_RBC.tar.gz", "metadata_name": "CD235a_fileinfo.csv",
    },
    "leukocytes": {
        "data": "https://zenodo.org/api/records/7412739/files/CD45RB_Leukocyte.tar.gz/content",
        "metadata": "https://zenodo.org/api/records/7412739/files/CD45RB_fileinfo.csv/content",
        "data_name": "CD45RB_Leukocyte.tar.gz", "metadata_name": "CD45RB_fileinfo.csv",
    },
    "lymphocytes": {
        "data": "https://zenodo.org/api/records/7412529/files/CD3CD20_Lymphocyte.tar.gz/content",
        "metadata": "https://zenodo.org/api/records/7412529/files/CD3CD20_fileinfo.csv/content",
        "data_name": "CD3CD20_Lymphocyte.tar.gz", "metadata_name": "CD3CD20_fileinfo.csv",
    },
    "endothelium": {
        "data": "https://zenodo.org/api/records/7412512/files/ERG_Endothelium.tar.gz/content",
        "metadata": "https://zenodo.org/api/records/7412512/files/ERG_fileinfo.csv/content",
        "data_name": "ERG_Endothelium.tar.gz", "metadata_name": "ERG_fileinfo.csv",
    },
    "plasma_cells": {
        "data": "https://zenodo.org/api/records/7412500/files/MIST1_PlasmaCell.tar.gz/content",
        "metadata": "https://zenodo.org/api/records/7412500/files/MIST1_fileinfo.csv/content",
        "data_name": "MIST1_PlasmaCell.tar.gz", "metadata_name": "MIST1_fileinfo.csv",
    },
    "myeloid_cells": {
        "data": "https://zenodo.org/api/records/7412690/files/MNDA_MyeloidCell.tar.gz/content",
        "metadata": "https://zenodo.org/api/records/7412690/files/MNDA_fileinfo.csv/content",
        "data_name": "MNDA_MyeloidCell.tar.gz", "metadata_name": "MNDA_fileinfo.csv",
    },
}


def _get_data_name(cell_type):
    return URLS[cell_type]["data_name"].split(".")[0]


def _to_cell_types(cell_types):
    if cell_types is None:
        return list(URLS)
    if isinstance(cell_types, str):
        cell_types = [cell_types]
    invalid = set(cell_types) - set(URLS)
    if invalid:
        raise ValueError(f"Invalid cell type choices: {sorted(invalid)}.")
    return cell_types


def _is_gzip(path):
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def _save_as_h5(img_path, mask_path, h5_path):
    h5py = _h5py()

    img = np.asarray(load_image(img_path))
    mask = np.asarray(load_image(mask_path))
    if img.ndim == 3 and img.shape[-1] == 4:
        img = img[:, :, :-1]
    img = img.transpose(2, 0, 1)
    _, h, w = img.shape
    chunk_hw = (min(256, h), min(256, w))
    with h5py.File(h5_path, "w") as f:
        f.create_dataset("images/raw", data=img, compression="gzip", chunks=(1,) + chunk_hw)
        f.create_dataset("labels/mask", data=mask, compression="gzip", chunks=chunk_hw)


def _extract_data(tar_path, extract_path):
    extract_root = tar_path.parent.resolve() / "unprocessed"
    with tarfile.open(tar_path) as f:
        for member in f.getmembers():
            member_path = (extract_root / member.name).resolve()
            try:
                member_path.relative_to(extract_root)
            except ValueError:
                raise RuntimeError(f"Unsafe path in tar archive: {member.name}")
        f.extractall(extract_root)
    tar_path.unlink()
    h5_dir = extract_path / "data"
    h5_dir.mkdir(exist_ok=True, parents=True)
    for p in (extract_root / extract_path.name).glob("*_HE.png"):
        _save_as_h5(p, p.with_name(p.name.replace("_HE.png", "_mask.png")),
                    h5_dir / p.with_suffix(".h5").name)
    rmtree(extract_root)


def get_segpath_data(path: Union[os.PathLike, str],
                     cell_types: Optional[Union[str, List[str]]] = None,
                     download: bool = False) -> None:
    """Download the SegPath data for the chosen cell types."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if not download:
        return
    for cell_type in _to_cell_types(cell_types):
        source = URLS[cell_type]
        tar_path = path / source["data_name"]
        extracted_path = path / _get_data_name(cell_type)
        util.download_source(path / source["metadata_name"], source["metadata"], download)
        if not (extracted_path / "data").exists():
            util.download_source(tar_path, source["data"], download)
            _extract_data(tar_path, extracted_path)


def _get_paths_from_metadata(path, cell_type, split):
    metadata_path = path / URLS[cell_type]["metadata_name"]
    volume_dir = path / _get_data_name(cell_type) / "data"
    volume_paths = []
    open_file = gzip.open if _is_gzip(metadata_path) else open
    with open_file(metadata_path, mode="rt") as f:
        for row in csv.DictReader(f):
            if split is not None and row["train_val_test"] != split:
                continue
            filename = row["filename"]
            if not filename.endswith("_HE.png"):
                continue
            volume_path = volume_dir / Path(filename).name.replace(".png", ".h5")
            if volume_path.exists():
                volume_paths.append(str(volume_path))
    return volume_paths


def get_segpath_paths(path: Union[os.PathLike, str],
                      cell_types: Optional[Union[str, List[str]]] = None,
                      split: Optional[str] = None,
                      download: bool = False) -> List[str]:
    """Get paths to the preprocessed SegPath h5 files."""
    path = Path(path)
    if split is not None and split not in ("train", "val", "test"):
        raise ValueError(f"'{split}' is not a valid split choice.")
    cell_types = _to_cell_types(cell_types)
    get_segpath_data(path, cell_types, download)
    volume_paths = []
    for cell_type in cell_types:
        if (path / URLS[cell_type]["metadata_name"]).exists():
            volume_paths.extend(_get_paths_from_metadata(path, cell_type, split))
        else:
            if split is not None:
                raise RuntimeError(
                    "The SegPath metadata csv is required for split selection but was not found.")
            volume_paths.extend(sorted(
                glob(str(path / _get_data_name(cell_type) / "data" / "*.h5"))))
    return volume_paths


def get_segpath_dataset(path: Union[os.PathLike, str], patch_shape,
                        cell_types: Optional[Union[str, List[str]]] = None,
                        split: Optional[str] = None,
                        download: bool = False, **kwargs):
    """Get the SegPath dataset for tissue/cell-type semantic segmentation."""
    volume_paths = get_segpath_paths(path, cell_types, split, download)
    return default_segmentation_dataset(
        volume_paths, "images/raw", volume_paths, "labels/mask", patch_shape,
        is_seg_dataset=True, with_channels=True, ndim=2, **kwargs,
    )


def get_segpath_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                       cell_types: Optional[Union[str, List[str]]] = None,
                       split: Optional[str] = None,
                       download: bool = False, **kwargs) -> DataLoader:
    """Get the SegPath data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_segpath_dataset(path, patch_shape, cell_types=cell_types, split=split,
                             download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
