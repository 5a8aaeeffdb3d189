"""Scaffold-A549 dataset: 3D cell segmentation of A549 cells on scaffolds
(reference torch_em/data/datasets/light_microscopy/scaffold_a549.py).

From https://github.com/Kaiseem/Scaffold-A549.
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image
from .. import util

URL = "https://github.com/Kaiseem/Scaffold-A549/releases/download/v1.0/scaffold_a549.zip"
CHECKSUM = None


def get_scaffold_a549_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the Scaffold-A549 data."""
    data_dir = os.path.join(path, "scaffold_a549")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "scaffold_a549.zip")
    util.download_source(zip_path, URL, download, checksum=CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def _convert_to_tif(data_dir):
    Image = _pil_image()

    for subdir in ("train", "test"):
        for npy_path in util.natsorted(glob(os.path.join(data_dir, subdir, "*.npy"))):
            tif_path = npy_path.replace(".npy", ".tif")
            if os.path.exists(tif_path):
                continue
            arr = np.load(npy_path)
            mode = "I" if np.issubdtype(arr.dtype, np.integer) else "F"
            frames = [Image.fromarray(sl.astype("int32" if mode == "I" else "float32"),
                                      mode=mode) for sl in arr]
            frames[0].save(tif_path, save_all=True, append_images=frames[1:])


def get_scaffold_a549_paths(path: Union[os.PathLike, str], split: str = "test",
                            download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the Scaffold-A549 volumes; only the test split has
    labels (train is unlabeled)."""
    if split not in ("train", "test"):
        raise ValueError(f"'{split}' is not a valid split. Choose 'train' or 'test'.")
    data_dir = get_scaffold_a549_data(path, download)
    _convert_to_tif(data_dir)
    split_dir = os.path.join(data_dir, split)
    if split == "test":
        return ([os.path.join(split_dir, "sf_a549_21.tif")],
                [os.path.join(split_dir, "sf_a549_21_Label.tif")])
    raw_paths = [p for p in util.natsorted(glob(os.path.join(split_dir, "sf_a549_*.tif")))
                 if "Label" not in p]
    return raw_paths, []


def get_scaffold_a549_dataset(path: Union[os.PathLike, str], patch_shape,
                              download: bool = False, **kwargs):
    """Get the (labeled test split of the) Scaffold-A549 dataset."""
    raw_paths, label_paths = get_scaffold_a549_paths(path, "test", download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_scaffold_a549_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                             download: bool = False, **kwargs) -> DataLoader:
    """Get the Scaffold-A549 data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_scaffold_a549_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
