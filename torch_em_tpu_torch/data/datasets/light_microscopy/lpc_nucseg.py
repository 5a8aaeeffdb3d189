"""LPC NucSeg dataset: nucleus segmentation benchmark (Coelho 2009 ISBI)
(reference torch_em/data/datasets/light_microscopy/lpc_nucseg.py).

From https://github.com/luispedro/Coelho2009_ISBI_NuclearSegmentation.
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URL = ("https://github.com/luispedro/Coelho2009_ISBI_NuclearSegmentation/"
       "archive/refs/heads/master.zip")
SOURCES = ("gnf", "ic100")


def _create_h5_data(path, source):
    h5py = _h5py()

    repo_dir = os.path.join(path, "Coelho2009_ISBI_NuclearSegmentation-master")
    h5_dir = os.path.join(path, "h5_data", source)
    os.makedirs(h5_dir, exist_ok=True)
    raw_dir = os.path.join(repo_dir, "data", "images", "dna-images", source)
    label_dir = os.path.join(repo_dir, "data", "preprocessed-data", source)
    for raw_path in sorted(glob(os.path.join(raw_dir, "*.png"))):
        fname = os.path.basename(raw_path)
        h5_path = os.path.join(h5_dir, fname.replace(".png", ".h5"))
        if os.path.exists(h5_path):
            continue
        label_path = os.path.join(label_dir, fname)
        if not os.path.exists(label_path):
            continue
        raw = np.asarray(load_image(raw_path))
        if raw.ndim == 3:
            raw = raw[..., 0]
        labels = np.asarray(load_image(label_path))
        with h5py.File(h5_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=labels.astype("int64"), compression="gzip")
    return h5_dir


def get_lpc_nucseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the LPC NucSeg data (github archive)."""
    repo_dir = os.path.join(path, "Coelho2009_ISBI_NuclearSegmentation-master")
    if not os.path.exists(repo_dir):
        os.makedirs(path, exist_ok=True)
        zip_path = os.path.join(path, "lpc_nucseg.zip")
        util.download_source(zip_path, URL, download, checksum=None)
        util.unzip(zip_path, path)
    return repo_dir


def get_lpc_nucseg_paths(path: Union[os.PathLike, str], source: str = "gnf",
                         download: bool = False) -> List[str]:
    """Get paths to the LPC NucSeg volumes for a source ('gnf' / 'ic100')."""
    assert source in SOURCES, f"Invalid source: {source}"
    get_lpc_nucseg_data(path, download)
    h5_dir = os.path.join(path, "h5_data", source)
    if not os.path.exists(h5_dir) or not glob(os.path.join(h5_dir, "*.h5")):
        _create_h5_data(path, source)
    h5_paths = util.natsorted(glob(os.path.join(h5_dir, "*.h5")))
    assert len(h5_paths) > 0
    return h5_paths


def get_lpc_nucseg_dataset(path: Union[os.PathLike, str], patch_shape, source: str = "gnf",
                           download: bool = False, **kwargs):
    """Get the LPC NucSeg dataset for nucleus segmentation."""
    paths = get_lpc_nucseg_paths(path, source, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape,
                                        ndim=2, **kwargs)


def get_lpc_nucseg_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                          source: str = "gnf", download: bool = False,
                          **kwargs) -> DataLoader:
    """Get the LPC NucSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_lpc_nucseg_dataset(path, patch_shape, source=source, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
