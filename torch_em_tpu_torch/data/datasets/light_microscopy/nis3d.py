"""NIS3D dataset: 3D nucleus segmentation in fluorescence microscopy across
multiple species (reference
torch_em/data/datasets/light_microscopy/nis3d.py).

Hosted at https://zenodo.org/records/11456029.
"""

import os
import shutil
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/11456029/files/NIS3D.zip"
CHECKSUM = "3eb60b48eba87a5eeb71e9676d6df64296adc3dd93234a1db80cd9a0da28cd83"


def get_nis3d_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the NIS3D data."""
    data_dir = os.path.join(path, "NIS3D")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "NIS3D.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    # 'MusMusculus_2' ships its labels under an odd name; align it.
    for p in glob(os.path.join(data_dir, "**", "MusMusculus_2", "gt.tif"), recursive=True):
        shutil.move(p, p.replace("gt", "GroundTruth"))
    return data_dir


def get_nis3d_paths(path: Union[os.PathLike, str], split: Optional[str] = None,
                    split_type: Optional[str] = None,
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the NIS3D volumes; split_type is 'cross-image' or
    'in-image' (None returns the original volumes)."""
    data_dir = get_nis3d_data(path, download)
    if split_type is None:
        assert split is None, "Choose a 'split_type' before choosing a 'split'."
        split_type = "NIS3D"
    else:
        assert split_type in ("cross-image", "in-image")
        split_type = os.path.join("suggestive splitting", split_type)
    split = "**" if split is None else split + "/*"
    raw_paths = util.natsorted(glob(
        os.path.join(data_dir, split_type, split, "data.tif"), recursive=True))
    label_paths = util.natsorted(glob(
        os.path.join(data_dir, split_type, split, "GroundTruth.tif"), recursive=True))
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_nis3d_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                      split: Optional[str] = None, split_type: Optional[str] = None,
                      download: bool = False, **kwargs):
    """Get the NIS3D dataset for 3D nucleus segmentation."""
    raw_paths, label_paths = get_nis3d_paths(path, split, split_type, download)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=True, **kwargs)


def get_nis3d_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                     batch_size: int, split: Optional[str] = None,
                     split_type: Optional[str] = None, download: bool = False,
                     **kwargs) -> DataLoader:
    """Get the NIS3D data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_nis3d_dataset(path, patch_shape, split=split, split_type=split_type,
                           download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
