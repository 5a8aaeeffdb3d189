"""YeastCellSeg dataset: yeast cell segmentation in brightfield microscopy
(reference torch_em/data/datasets/light_microscopy/yeastcellseg.py).

Located at https://zenodo.org/records/344879.
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

BASE_URL = "https://zenodo.org/records/344879/files"
_FILENAMES = [f"DS01_{i:02d}" for i in range(1, 16)]


def _create_h5_data(path, raw_dir, gt_dir):
    h5py = _h5py()

    from ....ops.host import connected_components

    h5_dir = os.path.join(path, "h5_data")
    os.makedirs(h5_dir, exist_ok=True)
    for name in _FILENAMES:
        h5_path = os.path.join(h5_dir, f"{name}.h5")
        if os.path.exists(h5_path):
            continue
        img = np.asarray(load_image(os.path.join(raw_dir, f"{name}.tif")))
        gt = np.asarray(load_image(os.path.join(gt_dir, f"{name}_gt.tif")))
        semantic = (gt > 0).astype("uint8")
        instances = connected_components(semantic).astype("int64")
        with h5py.File(h5_path, "w") as f:
            f.create_dataset("raw", data=img, compression="gzip")
            f.create_dataset("labels/semantic", data=semantic, compression="gzip")
            f.create_dataset("labels/instances", data=instances, compression="gzip")
    return h5_dir


def get_yeastcellseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the YeastCellSeg data (per-file downloads, converted to h5)."""
    h5_dir = os.path.join(path, "h5_data")
    if os.path.exists(h5_dir) and len(glob(os.path.join(h5_dir, "*.h5"))) == len(_FILENAMES):
        return h5_dir
    raw_dir = os.path.join(path, "raw")
    gt_dir = os.path.join(path, "gt")
    os.makedirs(raw_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    for name in _FILENAMES:
        raw_path = os.path.join(raw_dir, f"{name}.tif")
        if not os.path.exists(raw_path):
            util.download_source(raw_path, f"{BASE_URL}/{name}.tif", download, checksum=None)
        gt_path = os.path.join(gt_dir, f"{name}_gt.tif")
        if not os.path.exists(gt_path):
            util.download_source(gt_path, f"{BASE_URL}/{name}_gt.tif", download, checksum=None)
    return _create_h5_data(path, raw_dir, gt_dir)


def get_yeastcellseg_paths(path: Union[os.PathLike, str],
                           download: bool = False) -> List[str]:
    """Get paths to the YeastCellSeg h5 volumes."""
    h5_dir = get_yeastcellseg_data(path, download)
    h5_paths = util.natsorted(glob(os.path.join(h5_dir, "*.h5")))
    assert len(h5_paths) == len(_FILENAMES)
    return h5_paths


def get_yeastcellseg_dataset(path: Union[os.PathLike, str], patch_shape,
                             label_choice: str = "instances",
                             download: bool = False, **kwargs):
    """Get the YeastCellSeg dataset (label_choice: 'instances' / 'semantic')."""
    paths = get_yeastcellseg_paths(path, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, f"labels/{label_choice}",
                                        patch_shape, ndim=2, **kwargs)


def get_yeastcellseg_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                            label_choice: str = "instances", download: bool = False,
                            **kwargs) -> DataLoader:
    """Get the YeastCellSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_yeastcellseg_dataset(path, patch_shape, label_choice=label_choice,
                                  download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
