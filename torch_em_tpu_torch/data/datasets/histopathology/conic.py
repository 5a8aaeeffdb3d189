"""CoNIC dataset: colon nucleus identification and counting challenge
(reference torch_em/data/datasets/histopathology/conic.py).

Data from https://drive.google.com/drive/folders/1il9jG7uA4-ebQ_lNmXbbF2eOK9uNwheb;
challenge: https://conic-challenge.grand-challenge.org/
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util
from ....utils.io import _h5py

URL = "https://drive.google.com/drive/folders/1il9jG7uA4-ebQ_lNmXbbF2eOK9uNwheb?usp=sharing"


def _create_split_list(path, split):
    """Stratified 80/20 source-level split (fixed seed, cached as csv)."""
    import pandas as pd

    split_csv = os.path.join(path, "split.csv")
    if os.path.exists(split_csv):
        split_df = pd.read_csv(split_csv)
    else:
        info = pd.read_csv(os.path.join(path, "patch_info.csv"))
        file_names = np.squeeze(info.to_numpy()).tolist()
        img_sources = np.unique([v.split("-")[0] for v in file_names])
        cohort_sources = [v.split("_")[0] for v in img_sources]
        _, cohort_sources = np.unique(cohort_sources, return_inverse=True)
        train_indices, valid_indices = util._stratified_shuffle_split(
            cohort_sources, train_size=0.8, test_size=0.2, random_state=5)
        train_cohorts = img_sources[train_indices]
        valid_cohorts = img_sources[valid_indices]
        train_names = np.unique([
            f for f in file_names for s in train_cohorts if s == f.split("-")[0]])
        valid_names = np.unique([
            f for f in file_names for s in valid_cohorts if s == f.split("-")[0]])
        train_idx = [file_names.index(v) for v in train_names]
        valid_idx = [file_names.index(v) for v in valid_names]
        while len(train_idx) > len(valid_idx):
            valid_idx.append(np.nan)
        splits = {"train": train_idx, "test": valid_idx}
        split_df = pd.DataFrame(splits)
        split_df.to_csv(split_csv, index=False)
    return [int(v) for v in split_df[split].dropna()]


def _extract_images(split, path):
    h5py = _h5py()

    split_list = set(_create_split_list(path, split))
    images = np.load(os.path.join(path, "images.npy"))
    labels = np.load(os.path.join(path, "labels.npy"))
    raw, instance_masks, semantic_masks = [], [], []
    for idx, (image, label) in enumerate(zip(images, labels)):
        if idx not in split_list:
            continue
        raw.append(image)
        instance_masks.append(label[:, :, 0])
        semantic_masks.append(label[:, :, 1])
    raw = np.stack(raw).transpose(3, 0, 1, 2)  # (B, H, W, C) -> (C, B, H, W)
    with h5py.File(os.path.join(path, f"{split}.h5"), "a") as f:
        f.create_dataset("raw", data=raw, compression="gzip")
        f.create_dataset("labels/instances", data=np.stack(instance_masks), compression="gzip")
        f.create_dataset("labels/semantic", data=np.stack(semantic_masks), compression="gzip")


def get_conic_data(path: Union[os.PathLike, str], split: str, download: bool = False) -> str:
    """Download (gdrive folder) and preprocess the CoNIC data."""
    assert split in ("train", "test"), f"Invalid split: {split}"
    data_dir = os.path.join(path, "data")
    h5_path = os.path.join(data_dir, f"{split}.h5")
    if os.path.exists(h5_path):
        return data_dir
    if not (os.path.exists(os.path.join(data_dir, "images.npy"))):
        util.download_source_gdrive(data_dir, URL, download, download_type="folder")
    _extract_images(split, data_dir)
    return data_dir


def get_conic_paths(path: Union[os.PathLike, str], split: str,
                    download: bool = False) -> List[str]:
    """Get the path to the CoNIC volume for a split."""
    data_dir = get_conic_data(path, split, download)
    return [os.path.join(data_dir, f"{split}.h5")]


def get_conic_dataset(path: Union[os.PathLike, str], patch_shape, split: str,
                      label_choice: str = "instances", download: bool = False, **kwargs):
    """Get the CoNIC dataset for nucleus segmentation."""
    paths = get_conic_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, f"labels/{label_choice}",
                                        patch_shape, ndim=2, with_channels=True, **kwargs)


def get_conic_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                     split: str, label_choice: str = "instances",
                     download: bool = False, **kwargs) -> DataLoader:
    """Get the CoNIC data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_conic_dataset(path, patch_shape, split, label_choice=label_choice,
                           download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
