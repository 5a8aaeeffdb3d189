"""DenseCell (platelet) dataset: dense cellular segmentation in SBF-SEM
(reference torch_em/data/datasets/electron_microscopy/densecell.py).

Publication: https://doi.org/10.1038/s41598-021-81590-0
"""

import os
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URL = "https://www.dropbox.com/s/68yclbraqq1diza/platelet_data_1219.zip?dl=1"
CHECKSUM = None

SPLIT_FILES = {
    "train": {"images": "train-images.tif", "labels": "train-labels.tif"},
    "val": {"images": "eval-images.tif", "labels": "eval-labels.tif"},
    "test": {"images": "test-images.tif", "labels": "test-labels.tif"},
}


def get_densecell_data(path: Union[os.PathLike, str], split: str,
                       download: bool = False) -> str:
    """Download and convert the DenseCell data for a split."""
    h5py = _h5py()

    assert split in SPLIT_FILES, f"Invalid split: {split}"
    data_path = os.path.join(path, f"densecell_{split}.h5")
    if os.path.exists(data_path):
        return data_path
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "platelet_data.zip")
    util.download_source(zip_path, URL, download, checksum=CHECKSUM)
    util.unzip(zip_path, path, remove=True)

    src_dir = os.path.join(path, "platelet_data")
    if not os.path.exists(src_dir):
        src_dir = path
    for _split, files in SPLIT_FILES.items():
        out_path = os.path.join(path, f"densecell_{_split}.h5")
        if os.path.exists(out_path):
            continue
        raw = np.asarray(load_image(os.path.join(src_dir, files["images"])))
        labels = np.asarray(load_image(os.path.join(src_dir, files["labels"])))
        assert raw.shape == labels.shape, f"{raw.shape} vs {labels.shape}"
        with h5py.File(out_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=labels, compression="gzip")
    return data_path


def get_densecell_paths(path: Union[os.PathLike, str], split: str,
                        download: bool = False) -> List[str]:
    """Get the path to the DenseCell volume for a split."""
    return [get_densecell_data(path, split, download)]


def get_densecell_dataset(path: Union[os.PathLike, str], patch_shape, split: str,
                          download: bool = False, **kwargs):
    """Get the DenseCell dataset for dense cell segmentation."""
    paths = get_densecell_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape, **kwargs)


def get_densecell_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                         split: str, download: bool = False, **kwargs) -> DataLoader:
    """Get the DenseCell data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_densecell_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
