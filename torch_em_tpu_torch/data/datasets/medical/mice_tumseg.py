"""Mice TumSeg dataset: tumor segmentation in micro-CT of mice
(reference torch_em/data/datasets/medical/mice_tumseg.py).

Publication: https://doi.org/10.1038/s41597-024-03814-y
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://erda.ku.dk/archives/ba4fcd9bfa0fb581d593297dd43d1fd1/TumSeg%20database.zip"
CHECKSUM = "1c0567358ec81b9e085434a0362c1c2981b791dc2733931aeb022174ecb80399"


def get_mice_tumseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the TumSeg data."""
    data_dir = os.path.join(path, "TumSeg database")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "TumSeg.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_mice_tumseg_paths(path: Union[os.PathLike, str], rater: str = "A",
                          download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the TumSeg CT volumes and annotations (rater 'A', 'B',
    'C' or 'STAPLE' consensus)."""
    data_dir = get_mice_tumseg_data(path, download)
    ann_choice = f"Annotator_{rater}" if rater in ("A", "B", "C") else rater
    raw_paths = util.natsorted(
        glob(os.path.join(data_dir, "Dataset*", "**", "CT*.nii.gz"), recursive=True))
    label_paths = util.natsorted(
        glob(os.path.join(data_dir, "Dataset*", "**", f"{ann_choice}*.nii.gz"), recursive=True))
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_mice_tumseg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                            rater: str = "A", download: bool = False, **kwargs):
    """Get the TumSeg dataset for tumor segmentation."""
    raw_paths, label_paths = get_mice_tumseg_paths(path, rater, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_mice_tumseg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                           batch_size: int, rater: str = "A", download: bool = False,
                           **kwargs) -> DataLoader:
    """Get the TumSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_mice_tumseg_dataset(path, patch_shape, rater=rater, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
