"""MBH-Seg dataset: multi-class brain hemorrhage segmentation in non-contrast
CT (reference torch_em/data/datasets/medical/mbh_seg.py).

From https://huggingface.co/datasets/WuBiao/BHSD;
challenge: https://www.mbhseg.com/
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://huggingface.co/datasets/WuBiao/BHSD/resolve/main/label_192.zip"
CHECKSUM = "582bf184af993541a4958a4d209a6a44e3bbe702a5daefaf9fb1733a4e7a6e39"


def get_mbh_seg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the MBH-Seg data."""
    data_dir = os.path.join(path, "label_192")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "label_192.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_mbh_seg_paths(path: Union[os.PathLike, str],
                      download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the MBH-Seg volumes and hemorrhage labels."""
    data_dir = get_mbh_seg_data(path, download)
    image_paths = util.natsorted(glob(os.path.join(data_dir, "images", "*.nii.gz")))
    gt_paths = util.natsorted(glob(os.path.join(data_dir, "ground truths", "*.nii.gz")))
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_mbh_seg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                        download: bool = False, **kwargs):
    """Get the MBH-Seg dataset for hemorrhage segmentation."""
    image_paths, gt_paths = get_mbh_seg_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_mbh_seg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                       batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the MBH-Seg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_mbh_seg_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
