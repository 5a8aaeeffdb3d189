"""YeastMS dataset: yeast cell segmentation in trap microstructures
(reference torch_em/data/datasets/light_microscopy/yeastms.py).

Hosted at https://tudatalib.ulb.tu-darmstadt.de/handle/tudatalib/3799;
the raw .pt tensors are converted to h5 with 'raw' and cell instance
'labels' (class 0 = cell, class 1 = trap microstructure).
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np
import torch

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

URL = ("https://tudatalib.ulb.tu-darmstadt.de/bitstream/handle/tudatalib/3799/"
       "yeast_cell_in_microstructures_dataset.zip")
CHECKSUM = "80d9e34266895a030b5dfbb81c25f9bd41e7d8c3d57f2c5aaeafd7c7c3a2d6b5"
VALID_SPLITS = ("train", "val", "test")


def _create_h5_data(path, split):
    h5py = _h5py()

    h5_dir = os.path.join(path, "h5_data", split)
    os.makedirs(h5_dir, exist_ok=True)
    input_dir = os.path.join(path, split, "inputs")
    instance_dir = os.path.join(path, split, "instances")
    class_dir = os.path.join(path, split, "classes")
    for input_path in util.natsorted(glob(os.path.join(input_dir, "*.pt"))):
        sample_id = os.path.basename(input_path)
        h5_path = os.path.join(h5_dir, sample_id.replace(".pt", ".h5"))
        if os.path.exists(h5_path):
            continue
        raw = torch.load(input_path, weights_only=False).numpy()
        instances = torch.load(os.path.join(instance_dir, sample_id),
                               weights_only=False).numpy()  # (N, H, W)
        classes = torch.load(os.path.join(class_dir, sample_id),
                             weights_only=False).numpy()  # (N,)
        labels = np.zeros(raw.shape, dtype="int64")
        cell_id = 1
        for i in range(instances.shape[0]):
            if classes[i] == 0:  # cell (1 = trap microstructure)
                labels[instances[i] > 0] = cell_id
                cell_id += 1
        with h5py.File(h5_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=labels, compression="gzip")
    return h5_dir


def get_yeastms_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the YeastMS data."""
    if os.path.exists(os.path.join(path, "train")):
        return path
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "yeast_cell_in_microstructures_dataset.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return path


def get_yeastms_paths(path: Union[os.PathLike, str], split: str = "train",
                      download: bool = False) -> List[str]:
    """Get paths to the preprocessed YeastMS h5 files."""
    assert split in VALID_SPLITS, f"'{split}' is not a valid split."
    get_yeastms_data(path, download)
    h5_dir = os.path.join(path, "h5_data", split)
    if not os.path.exists(h5_dir) or len(glob(os.path.join(h5_dir, "*.h5"))) == 0:
        _create_h5_data(path, split)
    h5_paths = util.natsorted(glob(os.path.join(h5_dir, "*.h5")))
    assert len(h5_paths) > 0, f"No data found for split '{split}'."
    return h5_paths


def get_yeastms_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        split: str = "train", download: bool = False, **kwargs):
    """Get the YeastMS dataset for yeast cell segmentation."""
    h5_paths = get_yeastms_paths(path, split, download)
    kwargs, _ = util.add_instance_label_transform(kwargs, add_binary_target=True)
    return default_segmentation_dataset(
        h5_paths, "raw", h5_paths, "labels", patch_shape,
        is_seg_dataset=True, ndim=2, **kwargs,
    )


def get_yeastms_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                       batch_size: int, split: str = "train",
                       download: bool = False, **kwargs) -> DataLoader:
    """Get the YeastMS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_yeastms_dataset(path, patch_shape, split=split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
