"""MitoEM v2 dataset: mitochondria segmentation across eight cell types
(reference torch_em/data/datasets/electron_microscopy/mitoemv2.py).

Located at https://doi.org/10.5281/zenodo.17635006;
publication: https://doi.org/10.1101/2025.11.12.687478

The published nifti volumes are converted to n5 for chunked access.
"""

import json
import os
from glob import glob
from typing import List, Optional, Sequence, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import write_data
from ....utils.medical_io import load_nifti
from .. import util

BASE_URL = "https://zenodo.org/records/17635006/files"

DATASETS = {
    "beta": "Dataset001_ME2-Beta",
    "jurkat": "Dataset002_ME2-Jurkat",
    "macro": "Dataset003_ME2-Macro",
    "mossy": "Dataset004_ME2-Mossy",
    "podo": "Dataset005_ME2-Podo",
    "pyra": "Dataset006_ME2-Pyra",
    "sperm": "Dataset007_ME2-Sperm",
    "stem": "Dataset008_ME2-Stem",
}
DATASET_NAMES = list(DATASETS.keys())


def _preprocess_dataset(path, dataset_name, dataset_dir):
    """Convert the published nifti pairs into combined n5 volumes."""
    n5_dir = os.path.join(path, "n5_data", dataset_name)
    os.makedirs(n5_dir, exist_ok=True)
    with open(os.path.join(dataset_dir, "split.json")) as f:
        split_info = json.load(f)[0]
    for split_name in ("train", "val", "test"):
        for sample in split_info.get(split_name, []):
            img_dir = "imagesTs" if split_name == "test" else "imagesTr"
            lbl_dir = "labelsTs" if split_name == "test" else "labelsTr"
            img_nifti = os.path.join(dataset_dir, img_dir, f"{sample}_0000.nii.gz")
            lbl_nifti = os.path.join(dataset_dir, lbl_dir, f"{sample}.nii.gz")
            if not (os.path.exists(img_nifti) and os.path.exists(lbl_nifti)):
                continue
            n5_path = os.path.join(n5_dir, f"{sample}.n5")
            if os.path.exists(n5_path):
                continue
            raw = np.asarray(load_nifti(img_nifti)).transpose(2, 1, 0)
            labels = np.asarray(load_nifti(lbl_nifti)).transpose(2, 1, 0)
            if sample == "me2-jurkat_train02":  # published with flipped axes
                labels = np.transpose(labels, (2, 1, 0))
            if raw.shape != labels.shape:
                raise RuntimeError("Shape mismatch between raw and labels.")
            chunks = tuple(min(c, s) for c, s in zip((32, 256, 256), raw.shape))
            write_data(n5_path, "raw", raw, chunks=chunks)
            write_data(n5_path, "labels", labels.astype("uint64"), chunks=chunks)
    return n5_dir


def get_mitoemv2_data(path: Union[os.PathLike, str], dataset: str,
                      download: bool = False) -> str:
    """Download and preprocess one MitoEM v2 sub-dataset."""
    assert dataset in DATASETS, f"'{dataset}' is not valid. Choose from {DATASET_NAMES}."
    dataset_folder = DATASETS[dataset]
    n5_dir = os.path.join(path, "n5_data", dataset)
    if os.path.exists(n5_dir) and glob(os.path.join(n5_dir, "*.n5")):
        return n5_dir
    os.makedirs(path, exist_ok=True)
    dataset_dir = os.path.join(path, dataset_folder)
    if not os.path.exists(dataset_dir):
        zip_path = os.path.join(path, f"{dataset_folder}.zip")
        util.download_source(zip_path, f"{BASE_URL}/{dataset_folder}.zip", download,
                             checksum=None)
        util.unzip(zip_path, path)
    return _preprocess_dataset(path, dataset, dataset_dir)


def get_mitoemv2_paths(path: Union[os.PathLike, str],
                       datasets: Optional[Sequence[str]] = None,
                       split: str = "train", download: bool = False) -> List[str]:
    """Get paths to the MitoEM v2 n5 volumes for a split."""
    assert split in ("train", "val", "test"), f"'{split}' is not a valid split."
    if datasets is None:
        datasets = DATASET_NAMES
    elif isinstance(datasets, str):
        datasets = [datasets]
    all_n5_paths = []
    for ds in datasets:
        n5_dir = get_mitoemv2_data(path, ds, download)
        with open(os.path.join(path, DATASETS[ds], "split.json")) as f:
            split_info = json.load(f)[0]
        for sample in split_info.get(split, []):
            n5_path = os.path.join(n5_dir, f"{sample}.n5")
            if os.path.exists(n5_path):
                all_n5_paths.append(n5_path)
    return all_n5_paths


def get_mitoemv2_dataset(path: Union[os.PathLike, str], patch_shape,
                         datasets: Optional[Sequence[str]] = None, split: str = "train",
                         download: bool = False, **kwargs):
    """Get the MitoEM v2 dataset for mitochondria segmentation."""
    paths = get_mitoemv2_paths(path, datasets, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape, **kwargs)


def get_mitoemv2_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                        datasets: Optional[Sequence[str]] = None, split: str = "train",
                        download: bool = False, **kwargs) -> DataLoader:
    """Get the MitoEM v2 data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_mitoemv2_dataset(path, patch_shape, datasets=datasets, split=split,
                              download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
