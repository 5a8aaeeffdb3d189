"""NuClick dataset: lymphocyte segmentation in IHC images
(reference torch_em/data/datasets/histopathology/nuclick.py).

From https://warwick.ac.uk/fac/cross_fac/tia/data/nuclick/.
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util
from ....utils.io import _pil_image

URL = "https://warwick.ac.uk/fac/cross_fac/tia/data/nuclick/ihc_nuclick.zip"
CHECKSUM = "5128f1dfcba531e89b49e26364bc667eeb9978fa0039baa25a7f73fdaec2d736"


def get_nuclick_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the NuClick data."""
    data_dir = os.path.join(path, "IHC_nuclick", "IHC")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "ihc_nuclick.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_nuclick_paths(path: Union[os.PathLike, str], split: str = "Train",
                      download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the NuClick images and (npy->tif converted) labels
    (split 'Train' / 'Validation')."""
    Image = _pil_image()

    data_dir = get_nuclick_data(path, download)
    raw_paths = util.natsorted(glob(os.path.join(data_dir, "images", split, "*.png")))
    label_paths = util.natsorted(glob(os.path.join(data_dir, "masks", split, "*.npy")))
    neu_label_paths = []
    for lpath in label_paths:
        neu_lpath = str(Path(lpath).with_suffix(".tif"))
        neu_label_paths.append(neu_lpath)
        if os.path.exists(neu_lpath):
            continue
        Image.fromarray(np.load(lpath).astype("int32"), mode="I").save(neu_lpath)
    assert len(raw_paths) == len(neu_label_paths)
    return raw_paths, neu_label_paths


def get_nuclick_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        split: str = "Train", download: bool = False, **kwargs):
    """Get the NuClick dataset for lymphocyte segmentation."""
    raw_paths, label_paths = get_nuclick_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_nuclick_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                       batch_size: int, split: str = "Train", download: bool = False,
                       **kwargs) -> DataLoader:
    """Get the NuClick data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_nuclick_dataset(path, patch_shape, split=split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
