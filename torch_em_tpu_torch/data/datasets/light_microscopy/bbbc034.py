"""BBBC034 dataset: 3D nucleus instance segmentation in induced pluripotent
human stem cells (reference
torch_em/data/datasets/light_microscopy/bbbc034.py).

Hosted at https://bbbc.broadinstitute.org/BBBC034.
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

IMAGE_URL = "https://data.broadinstitute.org/bbbc/BBBC034/BBBC034_v1_dataset.zip"
GT_URL = "https://data.broadinstitute.org/bbbc/BBBC034/BBBC034_v1_DatasetGroundTruth.zip"


def get_bbbc034_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the BBBC034v1 images and ground truth."""
    data_dir = os.path.join(path, "BBBC034")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    img_zip = os.path.join(path, "BBBC034_v1_dataset.zip")
    gt_zip = os.path.join(path, "BBBC034_v1_DatasetGroundTruth.zip")
    util.download_source(img_zip, IMAGE_URL, download)
    util.download_source(gt_zip, GT_URL, download)
    util.unzip(img_zip, data_dir)
    util.unzip(gt_zip, data_dir)
    return data_dir


def get_bbbc034_paths(path: Union[os.PathLike, str], channel: int = 2,
                      download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the BBBC034 stacks; channels: 0=CellMask, 1=GFP,
    2=Hoechst/DNA (annotated), 3=Brightfield."""
    data_dir = get_bbbc034_data(path, download)
    raw_paths = util.natsorted(glob(os.path.join(data_dir, f"*_C={channel}.tif")))
    label_path = os.path.join(data_dir, "ground_truth_segmented.tif")
    if len(raw_paths) == 0:
        raise RuntimeError(f"No image files found for channel {channel} in {data_dir}.")
    if not os.path.exists(label_path):
        raise RuntimeError(f"Ground truth file not found: {label_path}.")
    return raw_paths, [label_path]


def get_bbbc034_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                        channel: int = 2, download: bool = False, **kwargs):
    """Get the BBBC034 dataset for 3D nucleus segmentation."""
    raw_paths, label_paths = get_bbbc034_paths(path, channel, download)
    return default_segmentation_dataset(raw_paths, None, label_paths, None,
                                        patch_shape, **kwargs)


def get_bbbc034_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                       batch_size: int, channel: int = 2, download: bool = False,
                       **kwargs) -> DataLoader:
    """Get the BBBC034 data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_bbbc034_dataset(path, patch_shape, channel=channel, download=download,
                             **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
