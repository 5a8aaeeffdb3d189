"""BCCD dataset: blood cell segmentation in stained blood smears
(reference torch_em/data/datasets/light_microscopy/bccd.py).

Located at https://www.kaggle.com/datasets/jeetblahiri/bccd-dataset-with-mask.
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util


def _create_h5_data(path, split):
    h5py = _h5py()

    from ....ops.host import connected_components

    data_dir = os.path.join(path, "data", "BCCD Dataset with mask")
    h5_dir = os.path.join(path, "h5_data", split)
    os.makedirs(h5_dir, exist_ok=True)
    raw_dir = os.path.join(data_dir, split, "original")
    mask_dir = os.path.join(data_dir, split, "mask")
    for raw_path in sorted(glob(os.path.join(raw_dir, "*.png"))):
        fname = os.path.basename(raw_path)
        h5_path = os.path.join(h5_dir, fname.replace(".png", ".h5"))
        if os.path.exists(h5_path):
            continue
        mask_path = os.path.join(mask_dir, fname)
        if not os.path.exists(mask_path):
            continue
        raw = np.asarray(load_image(raw_path))
        mask = np.asarray(load_image(mask_path))
        if mask.ndim == 3:
            mask = mask[..., 0]
        semantic = (mask > 0).astype("uint8")
        instances = connected_components(semantic).astype("int64")
        with h5py.File(h5_path, "w") as f:
            if raw.ndim == 3:
                raw = raw.transpose(2, 0, 1)
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels/semantic", data=semantic, compression="gzip")
            f.create_dataset("labels/instances", data=instances, compression="gzip")
    return h5_dir


def get_bccd_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the BCCD data (kaggle)."""
    data_dir = os.path.join(path, "data")
    if not os.path.exists(data_dir):
        os.makedirs(path, exist_ok=True)
        util.download_source_kaggle(path, "jeetblahiri/bccd-dataset-with-mask", download)
        util.unzip(os.path.join(path, "bccd-dataset-with-mask.zip"), data_dir)
    return data_dir


def get_bccd_paths(path: Union[os.PathLike, str], split: str = "train",
                   download: bool = False) -> List[str]:
    """Get paths to the BCCD volumes for a split ('train' / 'test')."""
    get_bccd_data(path, download)
    h5_dir = os.path.join(path, "h5_data", split)
    if not os.path.exists(h5_dir) or not glob(os.path.join(h5_dir, "*.h5")):
        _create_h5_data(path, split)
    h5_paths = util.natsorted(glob(os.path.join(h5_dir, "*.h5")))
    assert len(h5_paths) > 0
    return h5_paths


def get_bccd_dataset(path: Union[os.PathLike, str], patch_shape, split: str = "train",
                     label_choice: str = "instances", download: bool = False, **kwargs):
    """Get the BCCD dataset for blood cell segmentation."""
    paths = get_bccd_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, f"labels/{label_choice}",
                                        patch_shape, ndim=2, with_channels=True, **kwargs)


def get_bccd_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                    split: str = "train", label_choice: str = "instances",
                    download: bool = False, **kwargs) -> DataLoader:
    """Get the BCCD data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_bccd_dataset(path, patch_shape, split=split, label_choice=label_choice,
                          download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
