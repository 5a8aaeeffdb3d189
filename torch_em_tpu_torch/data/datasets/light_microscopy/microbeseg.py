"""microbeSEG dataset: microbe instance segmentation in phase contrast and
fluorescence (reference torch_em/data/datasets/light_microscopy/microbeseg.py).

Located at https://zenodo.org/records/6497715;
publication: https://doi.org/10.1371/journal.pone.0277601
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/6497715/files/microbeSEG_dataset.zip"
CHECKSUM = None
SPLITS = ("train", "val", "test", "complete")
ANNOTATION_TYPES = ("30min-man", "30min-man_15min-pre")


def get_microbeseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the microbeSEG data."""
    data_dir = os.path.join(path, "microbeSEG_dataset")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "microbeSEG_dataset.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_microbeseg_paths(path: Union[os.PathLike, str], split: str = "train",
                         annotation_type: str = "30min-man_15min-pre",
                         download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the microbeSEG images and masks."""
    assert split in SPLITS, f"'{split}' is not a valid split. Choose from {SPLITS}."
    assert annotation_type in ANNOTATION_TYPES, \
        f"'{annotation_type}' is not a valid annotation type."
    data_dir = get_microbeseg_data(path, download)
    split_dir = os.path.join(data_dir, annotation_type, split)
    assert os.path.exists(split_dir), f"Split directory not found: {split_dir}"
    image_paths = util.natsorted(glob(os.path.join(split_dir, "img_*.tif")))
    seg_paths = util.natsorted(glob(os.path.join(split_dir, "mask_*.tif")))
    assert len(image_paths) == len(seg_paths)
    return image_paths, seg_paths


def get_microbeseg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                           split: str = "train",
                           annotation_type: str = "30min-man_15min-pre",
                           download: bool = False, **kwargs):
    """Get the microbeSEG dataset for microbe segmentation."""
    image_paths, seg_paths = get_microbeseg_paths(path, split, annotation_type, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(image_paths, None, seg_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_microbeseg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          batch_size: int, split: str = "train",
                          annotation_type: str = "30min-man_15min-pre",
                          download: bool = False, **kwargs) -> DataLoader:
    """Get the microbeSEG data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_microbeseg_dataset(path, patch_shape, split=split,
                                annotation_type=annotation_type, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
