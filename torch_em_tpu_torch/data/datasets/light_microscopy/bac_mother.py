"""Bacteria mother-machine dataset in CTC layout
(reference torch_em/data/datasets/light_microscopy/bac_mother.py).

Located at https://zenodo.org/records/11237127.
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/11237127/files/CTC.zip"
CHECKSUM = "280f4cacda12094b6eafaae772ce7ea25f8ad6093d2ec2b3d381504dbea70ed3"


def get_bac_mother_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the bacteria mother-machine data."""
    data_dir = os.path.join(path, "CTC")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "CTC.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_bac_mother_paths(path: Union[os.PathLike, str], split: str,
                         download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the images and CTC-style SEG labels for a split."""
    assert split in ("train", "val", "test"), f"'{split}' is not a valid data split."
    data_path = os.path.join(get_bac_mother_data(path, download), split)
    raw_dirs = [p for p in glob(os.path.join(data_path, "*")) if not p.endswith("_GT")]
    raw_paths, label_paths = [], []
    for raw_dir in raw_dirs:
        raw_paths.extend(util.natsorted(glob(os.path.join(raw_dir, "t*.tif"))))
        label_paths.extend(util.natsorted(glob(os.path.join(f"{raw_dir}_GT", "SEG", "man_seg*.tif"))))
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_bac_mother_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                           split: str, boundaries: bool = False, binary: bool = False,
                           download: bool = False, **kwargs):
    """Get the bacteria mother-machine dataset."""
    raw_paths, label_paths = get_bac_mother_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries,
    )
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_bac_mother_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          batch_size: int, split: str, boundaries: bool = False,
                          binary: bool = False, download: bool = False, **kwargs) -> DataLoader:
    """Get the bacteria mother-machine data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_bac_mother_dataset(path, patch_shape, split, boundaries=boundaries,
                                binary=binary, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
