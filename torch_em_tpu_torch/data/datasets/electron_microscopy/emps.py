"""EMPS dataset: electron-microscopy particle segmentation
(reference torch_em/data/datasets/electron_microscopy/emps.py).

Available at https://github.com/by256/emps;
publication: https://doi.org/10.1021/acs.jcim.0c01455
"""

import os
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URL = "https://github.com/by256/emps/archive/refs/heads/main.zip"
CHECKSUM = None  # github archive checksums are not stable


def _create_h5_files(data_root, split, out_dir):
    """Convert the png image/segmap pairs of a split into h5 files."""
    h5py = _h5py()

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(data_root, f"{split}.csv")) as f:
        filenames = [line.strip() for line in f if line.strip()]
    filenames = [fn if fn.endswith(".png") else f"{fn}.png" for fn in filenames]
    for fname in filenames:
        image_path = os.path.join(data_root, "images", fname)
        seg_path = os.path.join(data_root, "segmaps", fname)
        if not (os.path.exists(image_path) and os.path.exists(seg_path)):
            continue
        raw = np.asarray(load_image(image_path))
        if raw.ndim == 3:
            raw = raw[..., :3].transpose(2, 0, 1)
        labels = np.asarray(load_image(seg_path))
        out_path = os.path.join(out_dir, f"{os.path.splitext(fname)[0]}.h5")
        with h5py.File(out_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=labels, compression="gzip")


def get_emps_data(path: Union[os.PathLike, str], split: str, download: bool = False) -> str:
    """Download and convert the EMPS data for a split ('train' / 'test')."""
    assert split in ("train", "test"), f"Invalid split: {split}"
    out_dir = os.path.join(path, split)
    if os.path.exists(out_dir):
        return out_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "emps.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    data_root = os.path.join(path, "emps-main")
    for _split in ("train", "test"):
        _create_h5_files(data_root, _split, os.path.join(path, _split))
    return out_dir


def get_emps_paths(path: Union[os.PathLike, str], split: str,
                   download: bool = False) -> List[str]:
    """Get paths to the EMPS volumes for a split."""
    from glob import glob

    out_dir = get_emps_data(path, split, download)
    return util.natsorted(glob(os.path.join(out_dir, "*.h5")))


def get_emps_dataset(path: Union[os.PathLike, str], patch_shape, split: str,
                     download: bool = False, **kwargs):
    """Get the EMPS dataset for particle instance segmentation."""
    paths = get_emps_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape,
                                        ndim=2, **kwargs)


def get_emps_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                    split: str, download: bool = False, **kwargs) -> DataLoader:
    """Get the EMPS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_emps_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
