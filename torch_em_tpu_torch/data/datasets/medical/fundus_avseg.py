"""Fundus-AVSeg dataset: artery/vein segmentation in fundus images
(reference torch_em/data/datasets/medical/fundus_avseg.py).

Located at https://figshare.com/ndownloader/files/54093641.
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = "https://figshare.com/ndownloader/files/54093641"
CHECKSUM = "6db5ff43c4e9c25aa93093aa295c67b10fa0c089ac650df6665c7a6bbae9539f"


def _process_labels(data_dir):
    """Map the RGB annotations to class ids (1 artery / 2 vein / 3 overlap /
    4 unknown)."""
    Image = _pil_image()

    for label_path in glob(os.path.join(data_dir, "annotation", "*.png")):
        labels = np.asarray(load_image(label_path))
        neu_labels = np.zeros(labels.shape[:2], dtype="uint8")
        neu_labels[np.all(labels[..., :3] == (255, 0, 0), axis=-1)] = 1
        neu_labels[np.all(labels[..., :3] == (0, 0, 255), axis=-1)] = 2
        neu_labels[np.all(labels[..., :3] == (0, 255, 0), axis=-1)] = 3
        neu_labels[np.all(labels[..., :3] == (255, 255, 255), axis=-1)] = 4
        Image.fromarray(neu_labels).save(Path(label_path).with_suffix(".tif"))
        os.remove(label_path)


def get_fundus_avseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the Fundus-AVSeg data."""
    data_dir = os.path.join(path, "Fundus-AVSeg")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "Fundus_AVSeg.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    _process_labels(data_dir)
    return data_dir


def get_fundus_avseg_paths(path: Union[os.PathLike, str], split: str,
                           download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the Fundus-AVSeg images and labels (last 15 of the
    published training list serve as the val split)."""
    import pandas as pd

    data_dir = get_fundus_avseg_data(path, download)
    if split == "test":
        df = pd.read_csv(os.path.join(data_dir, "testing.txt"))
    elif split in ("train", "val"):
        df = pd.read_csv(os.path.join(data_dir, "training.txt"))
    else:
        raise ValueError(f"'{split}' is not a valid split choice.")
    fnames = df.iloc[:, 0].tolist()
    if split == "train":
        fnames = fnames[:-15]
    elif split == "val":
        fnames = fnames[-15:]
    raw_paths = [os.path.join(data_dir, "images", f) for f in fnames]
    label_paths = [str(Path(os.path.join(data_dir, "annotation", f)).with_suffix(".tif"))
                   for f in fnames]
    return raw_paths, label_paths


def get_fundus_avseg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                             split: str, resize_inputs: bool = False,
                             download: bool = False, **kwargs):
    """Get the Fundus-AVSeg dataset for artery/vein segmentation."""
    raw_paths, label_paths = get_fundus_avseg_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_fundus_avseg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                            batch_size: int, split: str, resize_inputs: bool = False,
                            download: bool = False, **kwargs) -> DataLoader:
    """Get the Fundus-AVSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_fundus_avseg_dataset(path, patch_shape, split, resize_inputs=resize_inputs,
                                  download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
