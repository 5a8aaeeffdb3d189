"""Lizard dataset: nucleus segmentation in H&E-stained colon tissue
(reference torch_em/data/datasets/histopathology/lizard.py).

Publication: https://doi.org/10.48550/arXiv.2108.11195
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

SPLIT_MAP = {"train": 1, "val": 2, "test": 3}


def _create_split_list(path, split):
    import pandas as pd

    df = pd.read_csv(os.path.join(path, "lizard_labels", "Lizard_Labels", "info.csv"))
    return [df["Filename"].iloc[i] for i in df.index if df["Split"].iloc[i] == SPLIT_MAP[split]]


def _extract_images(split, image_folder, label_folder, output_dir):
    h5py = _h5py()
    from scipy.io import loadmat

    split_list = _create_split_list(output_dir, split)
    os.makedirs(os.path.join(output_dir, split), exist_ok=True)
    for image_file in glob(os.path.join(image_folder, "*.png")):
        fname = Path(os.path.split(image_file)[-1])
        if fname.stem not in split_list:
            continue
        label_file = os.path.join(label_folder, fname.with_suffix(".mat"))
        assert os.path.exists(label_file), label_file

        image = np.asarray(load_image(image_file))
        assert image.ndim == 3 and image.shape[-1] == 3
        labels = loadmat(label_file)
        segmentation = labels["inst_map"]
        assert image.shape[:-1] == segmentation.shape
        image = image.transpose((2, 0, 1))

        with h5py.File(os.path.join(output_dir, split, fname.with_suffix(".h5")), "a") as f:
            f.create_dataset("image", data=image, compression="gzip")
            f.create_dataset("labels/segmentation", data=segmentation, compression="gzip")
            f.create_dataset("labels/classes", data=labels["class"], compression="gzip")


def get_lizard_data(path: Union[os.PathLike, str], split: str, download: bool = False):
    """Download and preprocess the Lizard data for a split."""
    if split not in SPLIT_MAP:
        raise ValueError(f"'{split}' is not a valid split.")
    if glob(os.path.join(path, split, "*.h5")):
        return
    util.download_source_kaggle(path, "aadimator/lizard-dataset", download)
    zip_path = os.path.join(path, "lizard-dataset.zip")
    if os.path.exists(zip_path):
        util.unzip(zip_path, path)

    image_folder1 = os.path.join(path, "lizard_images1", "Lizard_Images1")
    image_folder2 = os.path.join(path, "lizard_images2", "Lizard_Images2")
    label_folder = os.path.join(path, "lizard_labels", "Lizard_Labels", "Labels")
    for image_folder in (image_folder1, image_folder2):
        _extract_images(split, image_folder, label_folder, path)


def get_lizard_paths(path: Union[os.PathLike, str], split: str,
                     download: bool = False) -> List[str]:
    """Get paths to the Lizard volumes for a split."""
    get_lizard_data(path, split, download)
    return util.natsorted(glob(os.path.join(path, split, "*.h5")))


def get_lizard_dataset(path: Union[os.PathLike, str], patch_shape, split: str,
                       download: bool = False, **kwargs):
    """Get the Lizard dataset for nucleus segmentation."""
    paths = get_lizard_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "image", paths, "labels/segmentation",
                                        patch_shape, ndim=2, with_channels=True, **kwargs)


def get_lizard_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                      split: str, download: bool = False, **kwargs) -> DataLoader:
    """Get the Lizard data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_lizard_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
