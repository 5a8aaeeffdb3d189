"""aiSEGcell dataset: nucleus segmentation in brightfield and fluorescence
microscopy (reference torch_em/data/datasets/light_microscopy/aisegcell.py).

Hosted at https://www.research-collection.ethz.ch/handle/20.500.11850/679085.
Per-image h5 volumes carry 'raw/brightfield', 'raw/fluorescence' (both CHW)
and instance 'labels'.
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....ops.host import connected_components
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URL = "https://libdrive.ethz.ch/index.php/s/VoF2SYkbLY8izjh/download"
CHECKSUM = "f9115ee6b71e7c4364b83f7d7f8b66dce5b778344070bddb6a8f0e5086ca5de9"


def _to_chw(im):
    if im.ndim == 3:
        return im.transpose(2, 0, 1)
    return np.stack([im] * 3, axis=0)


def _process_each_image(bpath, npath, gpath, data_dir):
    h5py = _h5py()

    parents = Path(bpath).parents
    split = parents[1].name.split("_")[-1]
    dname = parents[2].name
    out_dir = os.path.join(data_dir, split, dname)
    os.makedirs(out_dir, exist_ok=True)
    fpath = os.path.join(out_dir, f"{Path(bpath).stem}.h5")
    if os.path.exists(fpath):
        return
    bf = _to_chw(np.asarray(load_image(bpath)))
    nuc = _to_chw(np.asarray(load_image(npath)))
    gt = np.asarray(load_image(gpath))
    if gt.ndim == 3:
        gt = gt[..., 0]
    gt = connected_components(gt > 0).astype("uint16")
    with h5py.File(fpath, "w") as f:
        f.create_dataset("raw/brightfield", data=bf, compression="gzip")
        f.create_dataset("raw/fluorescence", data=nuc, compression="gzip")
        f.create_dataset("labels", data=gt, compression="gzip")


def _preprocess_data(data_dir, base_dir):
    bf_paths = util.natsorted(glob(
        os.path.join(base_dir, "**", "brightfield", "*.png"), recursive=True))
    nuc_paths = util.natsorted(glob(
        os.path.join(base_dir, "**", "nucleus", "*.png"), recursive=True))
    gt_paths = util.natsorted(glob(
        os.path.join(base_dir, "**", "masks", "*.png"), recursive=True))
    assert bf_paths and len(bf_paths) == len(nuc_paths) == len(gt_paths)
    for b, n, g in zip(bf_paths, nuc_paths, gt_paths):
        _process_each_image(b, n, g, data_dir)


def get_aisegcell_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the aiSEGcell nucleus data."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "data.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    util.unzip_tarfile(os.path.join(path, "679085", "aisegcell_supplement.tar"), path)
    util.unzip_tarfile(
        os.path.join(path, "aiSEGcell_supplement", "data_sets", "aiSEGcell_nucleus.tar"), path)
    _preprocess_data(data_dir, os.path.join(path, "aiSEGcell_nucleus"))
    return data_dir


def get_aisegcell_paths(path: Union[os.PathLike, str], split: str,
                        download: bool = False) -> List[str]:
    """Get paths to the preprocessed aiSEGcell h5 volumes for a split."""
    if split not in ("train", "val", "test"):
        raise ValueError(f"'{split}' is not a valid split choice.")
    data_dir = get_aisegcell_data(path, download)
    data_paths = glob(os.path.join(data_dir, split, "**", "*.h5"), recursive=True)
    assert len(data_paths) > 0
    return data_paths


def get_aisegcell_dataset(path: Union[os.PathLike, str], patch_shape, split: str,
                          raw_channel: str = "brightfield",
                          download: bool = False, **kwargs):
    """Get the aiSEGcell dataset for nucleus segmentation."""
    data_paths = get_aisegcell_paths(path, split, download)
    return default_segmentation_dataset(
        data_paths, f"raw/{raw_channel}", data_paths, "labels", patch_shape,
        is_seg_dataset=True, ndim=2, with_channels=True, **kwargs,
    )


def get_aisegcell_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                         split: str, raw_channel: str = "brightfield",
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the aiSEGcell data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_aisegcell_dataset(path, patch_shape, split, raw_channel=raw_channel,
                               download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
