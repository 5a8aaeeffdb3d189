"""LGG MRI dataset: low-grade glioma segmentation in brain MRI
(reference torch_em/data/datasets/medical/lgg_mri.py).

Located at https://www.kaggle.com/datasets/mateuszbuda/lgg-mri-segmentation.
"""

import os
import shutil
from glob import glob
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

CHANNELS = ("pre_contrast", "flair", "post_contrast")


def _merge_slices_to_volumes(path):
    h5py = _h5py()

    volume_dir = os.path.join(path, "data")
    os.makedirs(volume_dir, exist_ok=True)
    for patient_dir in glob(os.path.join(path, "kaggle_3m", "TCGA_*")):
        label_slice_paths = util.natsorted(glob(os.path.join(patient_dir, "*_mask.tif")))
        raw_slice_paths = [p.replace("_mask.tif", ".tif") for p in label_slice_paths]
        raw = np.stack([np.asarray(load_image(p)) for p in raw_slice_paths], axis=0)
        labels = np.stack([np.asarray(load_image(p)) for p in label_slice_paths], axis=0)
        volume_path = os.path.join(volume_dir, f"{os.path.basename(patient_dir)}.h5")
        with h5py.File(volume_path, "w") as f:
            f.create_dataset("raw/pre_contrast", data=raw[..., 0], compression="gzip")
            f.create_dataset("raw/flair", data=raw[..., 1], compression="gzip")
            f.create_dataset("raw/post_contrast", data=raw[..., 2], compression="gzip")
            f.create_dataset("labels", data=labels, compression="gzip")
    shutil.rmtree(os.path.join(path, "kaggle_3m"))


def get_lgg_mri_data(path: Union[os.PathLike, str], download: bool = False):
    """Download and preprocess the LGG MRI data (kaggle)."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(path, "mateuszbuda/lgg-mri-segmentation", download)
    util.unzip(os.path.join(path, "lgg-mri-segmentation.zip"), path)
    shutil.rmtree(os.path.join(path, "lgg-mri-segmentation"), ignore_errors=True)
    _merge_slices_to_volumes(path)


def get_lgg_mri_paths(path: Union[os.PathLike, str], split: str,
                      download: bool = False) -> List[str]:
    """Get paths to the LGG MRI volumes (70/15/rest split)."""
    get_lgg_mri_data(path, download)
    volume_paths = util.natsorted(glob(os.path.join(path, "data", "*.h5")))
    if split == "train":
        return volume_paths[:70]
    if split == "val":
        return volume_paths[70:85]
    if split == "test":
        return volume_paths[85:]
    raise ValueError(f"'{split}' is not a valid split.")


def get_lgg_mri_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                        split: str, channels: Optional[str] = None,
                        download: bool = False, **kwargs):
    """Get the LGG MRI dataset (channels: one of pre_contrast / flair /
    post_contrast, or None for all three stacked)."""
    paths = get_lgg_mri_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    if channels is None:
        raw_key = [f"raw/{c}" for c in CHANNELS]
        with_channels = True
    else:
        assert channels in CHANNELS, f"Invalid channel: {channels}"
        raw_key = f"raw/{channels}"
        with_channels = False
    return default_segmentation_dataset(paths, raw_key, paths, "labels", patch_shape,
                                        with_channels=with_channels, **kwargs)


def get_lgg_mri_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                       batch_size: int, split: str, channels: Optional[str] = None,
                       download: bool = False, **kwargs) -> DataLoader:
    """Get the LGG MRI data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_lgg_mri_dataset(path, patch_shape, split, channels=channels,
                             download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
