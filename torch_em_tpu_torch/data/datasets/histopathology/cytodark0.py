"""cytoDArk0 dataset: cell segmentation in Nissl-stained brain histology
(reference torch_em/data/datasets/histopathology/cytodark0.py).

Located at https://zenodo.org/records/13694738.
"""

import os
import shutil
from glob import glob
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URL = "https://zenodo.org/records/13694738/files/cytoDArk0.zip"
CHECKSUM = "ce4b05675aa5057e277c8d4ab74524307e2402a3703f6bd80643b93ca9b70ff8"


def _preprocess_images(path, data_dir):
    h5py = _h5py()
    import pandas as pd

    for mag, res in (("20x", "1024x1024"), ("40x", "2048x2048")):
        base_dir = os.path.join(data_dir, mag, res)
        preprocessed_dir = os.path.join(path, "preprocessed", mag)
        os.makedirs(preprocessed_dir, exist_ok=True)

        for image_path in glob(os.path.join(base_dir, "image", "*.png")):
            image_name = Path(image_path).stem
            image = np.asarray(load_image(image_path))
            instances = np.asarray(load_image(os.path.join(base_dir, "label", f"{image_name}.tiff")))
            semantics = np.asarray(load_image(os.path.join(base_dir, "graymask4", f"{image_name}.png")))
            with h5py.File(os.path.join(preprocessed_dir, f"{image_name}.h5"), "w") as f:
                f.create_dataset("raw", data=image.transpose(2, 0, 1), compression="gzip")
                f.create_dataset("labels/instances", data=instances, compression="gzip")
                f.create_dataset("labels/semantic/pixels_classification", data=semantics,
                                 compression="gzip")

        fold = pd.read_csv(os.path.join(base_dir, "folds.csv"))
        for i, split in enumerate(("train", "val", "test")):
            trg_dir = os.path.join(preprocessed_dir, split)
            os.makedirs(trg_dir, exist_ok=True)
            for img_id in fold.loc[fold["fold"] == i, "img_id"].tolist():
                src = os.path.join(preprocessed_dir, f"{img_id}.h5")
                if os.path.exists(src):
                    shutil.move(src, os.path.join(trg_dir, f"{img_id}.h5"))


def get_cytodark0_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the cytoDArk0 data."""
    data_dir = os.path.join(path, "preprocessed")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "cytoDArk0.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    _preprocess_images(path, os.path.join(path, "cytoDArk0"))
    return data_dir


def get_cytodark0_paths(path: Union[os.PathLike, str], split: str,
                        magnification: Optional[str] = None,
                        download: bool = False) -> List[str]:
    """Get paths to the cytoDArk0 volumes for a split (optionally filtered
    to one magnification, '20x' or '40x')."""
    data_dir = get_cytodark0_data(path, download)
    assert split in ("train", "val", "test"), split
    mag = "*" if magnification is None else magnification
    return util.natsorted(glob(os.path.join(data_dir, mag, split, "*.h5")))


def get_cytodark0_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          split: str, magnification: Optional[str] = None,
                          label_choice: str = "instances",
                          download: bool = False, **kwargs):
    """Get the cytoDArk0 dataset for cell segmentation."""
    paths = get_cytodark0_paths(path, split, magnification, download)
    label_key = "labels/instances" if label_choice == "instances" \
        else "labels/semantic/pixels_classification"
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, label_key, patch_shape,
                                        ndim=2, with_channels=True, **kwargs)


def get_cytodark0_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         batch_size: int, split: str, magnification: Optional[str] = None,
                         label_choice: str = "instances", download: bool = False,
                         **kwargs) -> DataLoader:
    """Get the cytoDArk0 data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_cytodark0_dataset(path, patch_shape, split, magnification=magnification,
                               label_choice=label_choice, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
