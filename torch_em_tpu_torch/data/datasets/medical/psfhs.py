"""PSFHS dataset: pubic symphysis and fetal head segmentation in ultrasound
(reference torch_em/data/datasets/medical/psfhs.py).

Located at https://zenodo.org/records/10969427;
publication: https://doi.org/10.1038/s41597-024-03266-4
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/10969427/files/PSFHS.zip"
CHECKSUM = "3f4a8126c84640e4d1b8a4e296d0dfd599cea6529b64b9ee00e5489bfd17ea95"


def get_psfhs_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the PSFHS data."""
    data_dir = os.path.join(path, "PSFHS")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "PSFHS.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_psfhs_paths(path: Union[os.PathLike, str], split: str,
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the PSFHS images and labels; the published set is split
    900 / 150 / rest into train / val / test."""
    data_dir = get_psfhs_data(path, download)
    raw_paths = util.natsorted(glob(os.path.join(data_dir, "image_mha", "*.mha")))
    label_paths = util.natsorted(glob(os.path.join(data_dir, "label_mha", "*.mha")))
    if split == "train":
        raw_paths, label_paths = raw_paths[:900], label_paths[:900]
    elif split == "val":
        raw_paths, label_paths = raw_paths[900:1050], label_paths[900:1050]
    elif split == "test":
        raw_paths, label_paths = raw_paths[1050:], label_paths[1050:]
    else:
        raise ValueError(f"'{split}' is not a valid split.")
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_psfhs_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                      split: str, resize_inputs: bool = False,
                      download: bool = False, **kwargs):
    """Get the PSFHS dataset."""
    raw_paths, label_paths = get_psfhs_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_psfhs_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     batch_size: int, split: str, resize_inputs: bool = False,
                     download: bool = False, **kwargs) -> DataLoader:
    """Get the PSFHS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_psfhs_dataset(path, patch_shape, split, resize_inputs=resize_inputs,
                           download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
