"""BlastoSPIM dataset: nucleus segmentation in SPIM volumes of mouse
blastocysts (reference
torch_em/data/datasets/light_microscopy/blastospim.py).

Located at https://plus.figshare.com/ndownloader/articles/26540593.
"""

import gzip
import os
from glob import glob
from pathlib import Path
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

URL = "https://plus.figshare.com/ndownloader/articles/26540593/versions/1"
CHECKSUM = "8be979c5a06cfad479a5cfe21b8bbb0e26f0e677cb052fe43275fa451fa9e9ac"


def _preprocess_inputs(data_dir):
    h5py = _h5py()

    raw_paths = util.natsorted(glob(os.path.join(data_dir, "*_image_*.npy.gz")))
    label_paths = util.natsorted(glob(os.path.join(data_dir, "*_masks_*.npy.gz")))
    preprocessed_dir = os.path.join(data_dir, "preprocessed")
    os.makedirs(preprocessed_dir, exist_ok=True)
    for rpath, lpath in zip(raw_paths, label_paths):
        vname = os.path.basename(rpath).split(".")[0]
        volume_path = os.path.join(preprocessed_dir, str(Path(vname).with_suffix(".h5")))
        if os.path.exists(volume_path):
            continue
        with gzip.open(rpath, "rb") as fr:
            raw = np.load(fr)
        with gzip.open(lpath, "rb") as fl:
            labels = np.load(fl)
        with h5py.File(volume_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=labels, compression="gzip")


def get_blastospim_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the BlastoSPIM data."""
    data_dir = os.path.join(path, "data", "preprocessed")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "blastospim.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, os.path.join(path, "data"))
    _preprocess_inputs(os.path.join(path, "data"))
    return data_dir


def get_blastospim_paths(path: Union[os.PathLike, str], download: bool = False) -> List[str]:
    """Get paths to the BlastoSPIM volumes."""
    data_dir = get_blastospim_data(path, download)
    return util.natsorted(glob(os.path.join(data_dir, "*.h5")))


def get_blastospim_dataset(path: Union[os.PathLike, str], patch_shape,
                           download: bool = False, **kwargs):
    """Get the BlastoSPIM dataset for nucleus segmentation."""
    paths = get_blastospim_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape, **kwargs)


def get_blastospim_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                          download: bool = False, **kwargs) -> DataLoader:
    """Get the BlastoSPIM data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_blastospim_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
