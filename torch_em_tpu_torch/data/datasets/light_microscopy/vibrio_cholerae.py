"""Vibrio cholerae dataset: bacteria segmentation in phase contrast
(reference torch_em/data/datasets/light_microscopy/vibrio_cholerae.py).

Located at https://zenodo.org/records/7704410.
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/7704410/files/ZENODO.zip"
CHECKSUM = "31edb3edbbd308261ead96fa6ec201aff4daf6a0fa8624462c0384e61d67d4c8"


def get_vibrio_cholerae_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the Vibrio cholerae data."""
    data_dir = os.path.join(path, "training-data-from-experimentally-acquired-images")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "ZENODO.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_vibrio_cholerae_paths(path: Union[os.PathLike, str],
                              download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the Vibrio cholerae images and labels."""
    data_dir = get_vibrio_cholerae_data(path, download)
    raw_paths = util.natsorted(glob(os.path.join(data_dir, "raw-data", "*_raw.tif")))
    label_paths = util.natsorted(
        glob(os.path.join(data_dir, "semi-manual-annotation", "*_labels.tif")))
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_vibrio_cholerae_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                                boundaries: bool = False, binary: bool = False,
                                download: bool = False, **kwargs):
    """Get the Vibrio cholerae dataset for bacteria segmentation."""
    raw_paths, label_paths = get_vibrio_cholerae_paths(path, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries,
    )
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_vibrio_cholerae_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                               batch_size: int, boundaries: bool = False, binary: bool = False,
                               download: bool = False, **kwargs) -> DataLoader:
    """Get the Vibrio cholerae data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_vibrio_cholerae_dataset(path, patch_shape, boundaries=boundaries, binary=binary,
                                     download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
