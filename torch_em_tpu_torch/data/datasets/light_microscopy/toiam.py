"""TOIAM dataset: organoid instance segmentation in brightfield microscopy
(reference torch_em/data/datasets/light_microscopy/toiam.py).

Located at https://doi.org/10.5281/zenodo.7260137;
publication: https://arxiv.org/html/2411.00552v1
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/7260137/files/ctc_format.zip"
CHECKSUM = "9ec73277b29f2b032037d9e07c73c428ff51456c23a5866bf214bf5a71590c31"


def get_toiam_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the TOIAM data."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "ctc_format.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, data_dir)
    return data_dir


def get_toiam_paths(path: Union[os.PathLike, str],
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the TOIAM images and instance labels (CTC layout)."""
    data_dir = get_toiam_data(path, download)
    raw_paths = util.natsorted(glob(os.path.join(data_dir, "0*", "*.tif")))
    label_paths = util.natsorted(glob(os.path.join(data_dir, "0*_GT", "SEG", "man_*.tif")))
    return raw_paths, label_paths


def get_toiam_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                      download: bool = False, **kwargs):
    """Get the TOIAM dataset for organoid segmentation."""
    raw_paths, label_paths = get_toiam_paths(path, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_toiam_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the TOIAM data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_toiam_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
