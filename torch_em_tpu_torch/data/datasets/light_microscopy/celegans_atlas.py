"""C. elegans nucleus atlas dataset: 3D nucleus segmentation
(reference torch_em/data/datasets/light_microscopy/celegans_atlas.py).

Located at https://zenodo.org/records/5942575; splits from
https://arxiv.org/abs/1908.03636.
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/5942575/files/c_elegans_nuclei.zip"
CHECKSUM = "1def07491cdad89e381cbe4437ef03da3af8f78d127e8152cd9b32bdab152c4e"


def get_celegans_atlas_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the C. elegans nucleus atlas data."""
    data_dir = os.path.join(path, "c_elegans_nuclei")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "c_elegans_nuclei.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_celegans_atlas_paths(path: Union[os.PathLike, str], split: str,
                             download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the C. elegans volumes for a split ('train'/'val'/'test')."""
    if split not in ("train", "val", "test"):
        raise ValueError(f"'{split}' is not a valid data split choice.")
    data_path = get_celegans_atlas_data(path, download)
    raw_paths = util.natsorted(glob(os.path.join(data_path, split, "images", "*.tif")))
    label_paths = util.natsorted(glob(os.path.join(data_path, split, "masks", "*.tif")))
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_celegans_atlas_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                               split: str, download: bool = False, **kwargs):
    """Get the C. elegans atlas dataset for 3D nucleus segmentation."""
    raw_paths, label_paths = get_celegans_atlas_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_celegans_atlas_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                              batch_size: int, split: str, download: bool = False,
                              **kwargs) -> DataLoader:
    """Get the C. elegans atlas data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_celegans_atlas_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
