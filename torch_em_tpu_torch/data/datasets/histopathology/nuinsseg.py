"""NuInsSeg dataset: nucleus instance segmentation in H&E across 31 organs
(reference torch_em/data/datasets/histopathology/nuinsseg.py).

Located at https://www.kaggle.com/datasets/ipateam/nuinsseg;
publication: https://doi.org/10.1038/s41597-024-03117-2
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util


def get_nuinsseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the NuInsSeg data."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(path, "ipateam/nuinsseg", download)
    zip_path = os.path.join(path, "nuinsseg.zip")
    util.unzip(zip_path, data_dir)
    return data_dir


def get_nuinsseg_paths(path: Union[os.PathLike, str],
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the NuInsSeg images and instance masks."""
    data_dir = get_nuinsseg_data(path, download)
    tissue_type_dirs = glob(os.path.join(data_dir, "*"))
    raw_paths = [
        p for d in tissue_type_dirs
        for p in util.natsorted(glob(os.path.join(d, "tissue images", "*.png")))
    ]
    label_paths = [
        p for d in tissue_type_dirs
        for p in util.natsorted(glob(os.path.join(d, "label masks modify", "*.tif")))
    ]
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_nuinsseg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         download: bool = False, **kwargs):
    """Get the NuInsSeg dataset for nucleus segmentation."""
    raw_paths, label_paths = get_nuinsseg_paths(path, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_nuinsseg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the NuInsSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_nuinsseg_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
