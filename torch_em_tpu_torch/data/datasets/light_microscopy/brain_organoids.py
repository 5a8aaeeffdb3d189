"""Brain organoids dataset: organoid segmentation in brightfield images
(reference torch_em/data/datasets/light_microscopy/brain_organoids.py).

Publication: https://doi.org/10.1038/s41597-024-03330-z
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image
from .. import util

URL = "https://zenodo.org/records/10301912/files/data.zip"
CHECKSUM = "bc2ed56717a65ccd49e27bac92c3b714ca4bb245299698b68baa599c9d510a26"


def get_brain_organoids_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the brain organoids data."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "data.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_brain_organoids_paths(path: Union[os.PathLike, str],
                              download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the brain organoid images and (tif-converted) labels."""
    Image = _pil_image()

    data_dir = get_brain_organoids_data(path, download)
    raw_paths = util.natsorted(glob(os.path.join(data_dir, "imgs", "*")))
    label_paths = util.natsorted(glob(os.path.join(data_dir, "labels", "*.npy")))

    preprocessed_dir = os.path.join(data_dir, "labels_preprocessed")
    os.makedirs(preprocessed_dir, exist_ok=True)
    neu_label_paths = []
    for lpath in label_paths:
        neu_lpath = lpath.replace("labels", "labels_preprocessed").replace(".npy", ".tif")
        neu_label_paths.append(neu_lpath)
        if os.path.exists(neu_lpath):
            continue
        label = np.load(lpath)
        Image.fromarray(label.astype("int32"), mode="I").save(neu_lpath)
    return raw_paths, neu_label_paths


def get_brain_organoids_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                                download: bool = False, **kwargs):
    """Get the brain organoids dataset."""
    raw_paths, label_paths = get_brain_organoids_paths(path, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_brain_organoids_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                               batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the brain organoids data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_brain_organoids_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
