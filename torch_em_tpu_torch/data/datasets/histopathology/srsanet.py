"""SRSA-Net dataset: nucleus segmentation in IHC-stained TMA images
(reference torch_em/data/datasets/histopathology/srsanet.py).

Located at https://doi.org/10.5281/zenodo.7647846; publication:
https://doi.org/10.1016/j.bspc.2024.106143
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

URL = "https://zenodo.org/records/7647846/files/IHC_TMA_dataset.zip"
CHECKSUM = "9dcc1c94b5d8af5383d3c91141617b1621904ee9bd6f69d2223e7f4363cc80d9"
_SPLIT_FOLDS = {"train": "fold1", "val": "fold2", "test": "fold3"}


def _preprocess_labels(data_dir):
    Image = _pil_image()

    from ....ops.host import connected_components

    preprocessed_label_dir = os.path.join(data_dir, "preprocessed_labels")
    os.makedirs(preprocessed_label_dir, exist_ok=True)
    for lpath in glob(os.path.join(data_dir, "masks", "*.npy")):
        larray = np.load(lpath)
        # two binary channels (positive / negative nuclei) -> instances
        labels = connected_components(larray[0] + larray[1]).astype("int32")
        Image.fromarray(labels, mode="I").save(
            os.path.join(preprocessed_label_dir, f"{Path(lpath).stem}.tif")
        )


def get_srsanet_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the SRSA-Net data."""
    data_dir = os.path.join(path, "IHC_TMA_dataset")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "IHC_TMA_dataset.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    _preprocess_labels(data_dir)
    return data_dir


def get_srsanet_paths(path: Union[os.PathLike, str], split: str,
                      download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the SRSA-Net images and instance labels; the published
    folds map to splits as fold1/fold2/fold3 = train/val/test."""
    if split not in _SPLIT_FOLDS:
        raise ValueError(f"'{split}' is not a valid split choice.")
    data_dir = get_srsanet_data(path, download)
    dname = _SPLIT_FOLDS[split]
    raw_paths = util.natsorted(glob(os.path.join(data_dir, "images", f"{dname}_*.png")))
    label_paths = util.natsorted(
        glob(os.path.join(data_dir, "preprocessed_labels", f"{dname}_*.tif")))
    return raw_paths, label_paths


def get_srsanet_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        split: str, offsets=None, boundaries: bool = False,
                        binary: bool = False, download: bool = False, **kwargs):
    """Get the SRSA-Net dataset for nucleus segmentation."""
    raw_paths, label_paths = get_srsanet_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_srsanet_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                       batch_size: int, split: str, offsets=None, boundaries: bool = False,
                       binary: bool = False, download: bool = False, **kwargs) -> DataLoader:
    """Get the SRSA-Net data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_srsanet_dataset(path, patch_shape, split, offsets=offsets, boundaries=boundaries,
                             binary=binary, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
