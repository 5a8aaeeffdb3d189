"""YeastSAM dataset: yeast cell segmentation in DIC microscopy
(reference torch_em/data/datasets/light_microscopy/yeastsam.py).

Located at https://zenodo.org/records/17204942;
publication: https://doi.org/10.1101/2025.09.17.676679
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/17204942/files/CLB2.zip?download=1"
CHECKSUM = "dc2f32a1ea79e2f65bc28ce79e41681d734b48d312f7fcf43956c4eae41af774"


def get_yeastsam_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the YeastSAM data."""
    data_dir = os.path.join(path, "DIC")
    if os.path.exists(data_dir):
        return path
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "CLB2.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return path


def get_yeastsam_paths(path: Union[os.PathLike, str],
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the YeastSAM images and masks."""
    get_yeastsam_data(path, download)
    image_paths = util.natsorted(glob(os.path.join(path, "DIC", "*.tif")))
    label_paths = util.natsorted(glob(os.path.join(path, "DIC_mask", "*.tif")))
    assert len(image_paths) == len(label_paths)
    return image_paths, label_paths


def get_yeastsam_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         download: bool = False, **kwargs):
    """Get the YeastSAM dataset for yeast segmentation."""
    image_paths, label_paths = get_yeastsam_paths(path, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(image_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_yeastsam_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the YeastSAM data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_yeastsam_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
