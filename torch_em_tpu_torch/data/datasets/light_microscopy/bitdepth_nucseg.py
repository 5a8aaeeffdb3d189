"""BitDepth NucSeg dataset: nucleus segmentation in DAPI images across bit
depths (reference
torch_em/data/datasets/light_microscopy/bitdepth_nucseg.py).

The data ships in the https://github.com/masih4/BitDepth_NucSeg repository.
"""

import os
import subprocess
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://github.com/masih4/BitDepth_NucSeg"


def get_bitdepth_nucseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Clone the BitDepth_NucSeg repository (the data ships in-repo)."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    if not download:
        raise RuntimeError("Cannot find the data; use download=True to clone it.")
    os.makedirs(path, exist_ok=True)
    subprocess.run(["git", "clone", "--quiet", URL, path], check=True)
    for zip_path in glob(os.path.join(path, "data", "*.zip")):
        util.unzip(zip_path, os.path.join(path, "data"), remove=False)
    return data_dir


def get_bitdepth_nucseg_paths(path: Union[os.PathLike, str],
                              magnification: Optional[str] = None,
                              download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the images (16 bit) and label masks, optionally filtered
    to one magnification subfolder."""
    data_dir = get_bitdepth_nucseg_data(path, download)
    mag = magnification if magnification is not None else "*"
    raw_paths = util.natsorted(glob(os.path.join(data_dir, mag, "images_16bit", "*.tif")))
    label_paths = util.natsorted(glob(os.path.join(data_dir, mag, "label masks", "*.tif")))
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_bitdepth_nucseg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                                magnification: Optional[str] = None,
                                download: bool = False, **kwargs):
    """Get the BitDepth NucSeg dataset for nucleus segmentation."""
    raw_paths, label_paths = get_bitdepth_nucseg_paths(path, magnification, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_bitdepth_nucseg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                               batch_size: int, magnification: Optional[str] = None,
                               download: bool = False, **kwargs) -> DataLoader:
    """Get the BitDepth NucSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_bitdepth_nucseg_dataset(path, patch_shape, magnification=magnification,
                                     download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
