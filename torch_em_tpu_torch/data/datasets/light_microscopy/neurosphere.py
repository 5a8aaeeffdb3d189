"""Neurosphere dataset: 3D nucleus segmentation in SPIM imaging of
neurospheres (reference
torch_em/data/datasets/light_microscopy/neurosphere.py).

From the OpenSegSPIM sample data (sourceforge).
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

RAW_URL = "https://downloads.sourceforge.net/project/opensegspim/Sample%20Data/Neurosphere_Dataset.zip"
LABEL_URL = "https://downloads.sourceforge.net/project/opensegspim/Sample%20Data/Neurosphere_OpenSegSPIM.zip"


def get_neurosphere_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the neurosphere data."""
    data_dir = os.path.join(path, "neurosphere")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(data_dir, exist_ok=True)
    raw_zip = os.path.join(path, "Neurosphere_Dataset.zip")
    label_zip = os.path.join(path, "Neurosphere_OpenSegSPIM.zip")
    util.download_source(raw_zip, RAW_URL, download, checksum=None)
    util.download_source(label_zip, LABEL_URL, download, checksum=None)
    util.unzip(raw_zip, data_dir)
    util.unzip(label_zip, data_dir)
    return data_dir


def _fill_labels(data_dir):
    """Convert thin-shell contour labels to filled 3D instances."""
    Image = _pil_image()
    from scipy.ndimage import binary_fill_holes

    filled_path = os.path.join(data_dir, "filled_labels.tif")
    if os.path.exists(filled_path):
        return filled_path
    label_paths = util.natsorted(
        glob(os.path.join(data_dir, "**", "Nucleisegmented2.tif"), recursive=True))
    if len(label_paths) == 0:
        raise RuntimeError(f"Label file 'Nucleisegmented2.tif' not found in {data_dir}.")
    raw_labels = np.asarray(load_image(label_paths[0]))
    instance_ids = np.unique(raw_labels)
    instance_ids = instance_ids[instance_ids != 0]
    filled = np.zeros(raw_labels.shape, dtype=np.int32)
    for new_id, val in enumerate(instance_ids, start=1):
        filled[binary_fill_holes(raw_labels == val)] = new_id
    frames = [Image.fromarray(sl, mode="I") for sl in filled]
    frames[0].save(filled_path, save_all=True, append_images=frames[1:])
    return filled_path


def get_neurosphere_paths(path: Union[os.PathLike, str],
                          download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the neurosphere volume and filled labels."""
    data_dir = get_neurosphere_data(path, download)
    raw_paths = util.natsorted(glob(os.path.join(data_dir, "**", "OriginalStack.tif"),
                                    recursive=True))
    if len(raw_paths) == 0:
        raise RuntimeError(f"Raw image 'OriginalStack.tif' not found in {data_dir}.")
    return raw_paths[:1], [_fill_labels(data_dir)]


def get_neurosphere_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                            download: bool = False, **kwargs):
    """Get the neurosphere dataset for 3D nucleus segmentation."""
    raw_paths, label_paths = get_neurosphere_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_neurosphere_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                           batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the neurosphere data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_neurosphere_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
