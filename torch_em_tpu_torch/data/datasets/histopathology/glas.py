"""GlaS dataset: gland segmentation in H&E colon histology (MICCAI 2015
challenge) (reference torch_em/data/datasets/histopathology/glas.py).

Located at https://www.kaggle.com/datasets/sani84/glasmiccai2015-gland-segmentation.
"""

import os
import shutil
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util


def _extract_images(split, path):
    h5py = _h5py()

    data_folder = os.path.join(path, "Warwick_QU_Dataset")
    label_paths = util.natsorted(glob(os.path.join(data_folder, f"{split}*anno.bmp")))
    image_paths = [
        p for p in util.natsorted(glob(os.path.join(data_folder, f"{split}*.bmp")))
        if p not in label_paths
    ]
    assert image_paths and len(image_paths) == len(label_paths)
    os.makedirs(os.path.join(path, split), exist_ok=True)
    for image_path, label_path in zip(image_paths, label_paths):
        fname = os.path.basename(image_path).split(".")[0]
        image = np.asarray(load_image(image_path)).transpose(2, 0, 1)
        segmentation = np.asarray(load_image(label_path))
        with h5py.File(os.path.join(path, split, f"{fname}.h5"), "a") as f:
            f.create_dataset("raw", data=image, compression="gzip")
            f.create_dataset("labels", data=segmentation, compression="gzip")


def get_glas_data(path: Union[os.PathLike, str], split: str, download: bool = False) -> str:
    """Download and preprocess the GlaS data (kaggle)."""
    data_dir = os.path.join(path, split)
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(path, "sani84/glasmiccai2015-gland-segmentation", download)
    zip_path = os.path.join(path, "glasmiccai2015-gland-segmentation.zip")
    if os.path.exists(zip_path):
        util.unzip(zip_path, path)
    if split not in ("train", "test"):
        raise ValueError(f"'{split}' is not a valid split choice.")
    for _split in ("train", "test"):
        _extract_images(_split, path)
    shutil.rmtree(os.path.join(path, "Warwick_QU_Dataset"), ignore_errors=True)
    return data_dir


def get_glas_paths(path: Union[os.PathLike, str], split: str,
                   download: bool = False) -> List[str]:
    """Get paths to the GlaS volumes for a split ('train' / 'test')."""
    data_dir = get_glas_data(path, split, download)
    return util.natsorted(glob(os.path.join(data_dir, "*.h5")))


def get_glas_dataset(path: Union[os.PathLike, str], patch_shape, split: str,
                     download: bool = False, **kwargs):
    """Get the GlaS dataset for gland segmentation."""
    paths = get_glas_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape,
                                        ndim=2, with_channels=True, **kwargs)


def get_glas_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int, split: str,
                    download: bool = False, **kwargs) -> DataLoader:
    """Get the GlaS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_glas_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
