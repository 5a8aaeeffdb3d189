"""PanNuke nucleus segmentation in histopathology (reference
torch_em/data/datasets/histopathology/pannuke.py).

Publication: https://doi.org/10.48550/arXiv.2003.10778
"""

import os
from glob import glob
from typing import List, Sequence, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util
from ....utils.io import _h5py

URLS = {
    "fold_1": "https://warwick.ac.uk/fac/cross_fac/tia/data/pannuke/fold_1.zip",
    "fold_2": "https://warwick.ac.uk/fac/cross_fac/tia/data/pannuke/fold_2.zip",
    "fold_3": "https://warwick.ac.uk/fac/cross_fac/tia/data/pannuke/fold_3.zip",
}
CHECKSUM = {
    "fold_1": "6e19ad380300e8ce9480f9ab6a14cc91fa4b6a511609b40e3d70bdf9c881ed0b",
    "fold_2": "5bc540cc509f64b5f5a274d6e5a245527dbd3e6d3155d43555115c5d54709b07",
    "fold_3": "c14d372981c42f611ebc80afad01702b89cad8c1b3089daa31931cf5a4b1a39d",
}


def _convert_fold(path, fold):
    """Convert the npy fold data into one h5 volume per fold."""
    h5py = _h5py()

    h5_path = os.path.join(path, f"pannuke_{fold}.h5")
    if os.path.exists(h5_path):
        return h5_path
    fold_dir = os.path.join(path, fold)
    image_files = glob(os.path.join(fold_dir, "**", "images.npy"), recursive=True)
    mask_files = glob(os.path.join(fold_dir, "**", "masks.npy"), recursive=True)
    assert image_files and mask_files, fold_dir
    images = np.load(image_files[0])  # (N, 256, 256, 3)
    masks = np.load(mask_files[0])    # (N, 256, 256, 6)
    # instance labels: combine the five nucleus-type channels into instances
    instances = np.zeros(masks.shape[:3], dtype="uint32")
    offset = 0
    for c in range(5):
        channel = masks[..., c].astype("uint32")
        nonzero = channel > 0
        instances[nonzero] = channel[nonzero] + offset
        offset = instances.max()
    with h5py.File(h5_path, "w") as f:
        f.create_dataset("images", data=images.transpose(3, 0, 1, 2), compression="gzip")
        f.create_dataset("labels/instances", data=instances, compression="gzip")
        f.create_dataset("labels/semantic", data=np.argmax(masks, axis=-1), compression="gzip")
    return h5_path


def get_pannuke_data(path: Union[os.PathLike, str], download: bool,
                     folds: Sequence[str] = ("fold_1", "fold_2", "fold_3")) -> None:
    """Download the PanNuke data."""
    os.makedirs(path, exist_ok=True)
    for fold in folds:
        assert fold in URLS, f"Invalid fold {fold}."
        if os.path.exists(os.path.join(path, f"pannuke_{fold}.h5")):
            continue
        zip_path = os.path.join(path, f"{fold}.zip")
        util.download_source(zip_path, URLS[fold], download, CHECKSUM[fold])
        util.unzip(zip_path, os.path.join(path, fold), remove=True)
        _convert_fold(path, fold)


def get_pannuke_paths(path: Union[os.PathLike, str],
                      folds: Sequence[str] = ("fold_1", "fold_2", "fold_3"),
                      download: bool = False) -> List[str]:
    """Get paths to the PanNuke fold volumes."""
    get_pannuke_data(path, download, folds)
    return [os.path.join(path, f"pannuke_{fold}.h5") for fold in folds]


def get_pannuke_dataset(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, ...],
    folds: Sequence[str] = ("fold_1", "fold_2", "fold_3"),
    download: bool = False,
    custom_label_choice: str = "instances",
    with_channels: bool = True,
    with_label_channels: bool = False,
    **kwargs,
):
    """Get the PanNuke dataset for nucleus segmentation."""
    assert custom_label_choice in ("instances", "semantic")
    data_paths = get_pannuke_paths(path, folds, download)
    return default_segmentation_dataset(
        data_paths, "images", data_paths, f"labels/{custom_label_choice}", patch_shape,
        is_seg_dataset=True, with_channels=with_channels,
        with_label_channels=with_label_channels, **kwargs,
    )


def get_pannuke_loader(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, ...],
    batch_size: int,
    folds: Sequence[str] = ("fold_1", "fold_2", "fold_3"),
    download: bool = False,
    custom_label_choice: str = "instances",
    **kwargs,
) -> DataLoader:
    """Get the PanNuke data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_pannuke_dataset(
        path, patch_shape, folds=folds, download=download,
        custom_label_choice=custom_label_choice, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
