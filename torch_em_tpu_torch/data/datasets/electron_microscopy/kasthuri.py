"""Kasthuri mitochondria segmentation dataset (reference
torch_em/data/datasets/electron_microscopy/kasthuri.py).

Publication: https://doi.org/10.48550/arXiv.1812.06024
"""

import os
from concurrent import futures
from glob import glob
from shutil import rmtree
from typing import Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, _pil_image
from .. import util

URL = "http://www.casser.io/files/kasthuri_pp.zip "
CHECKSUM = "bbb78fd205ec9b57feb8f93ebbdf1666261cbc3e0305e7f11583ab5157a3d792"


def _load_volume(path):
    Image = _pil_image()

    files = sorted(glob(os.path.join(path, "*.png")))
    im0 = np.asarray(Image.open(files[0]))
    out = np.zeros((len(files),) + im0.shape, dtype=im0.dtype)
    out[0] = im0

    def _loadz(z):
        out[z] = np.asarray(Image.open(files[z]))

    with futures.ThreadPoolExecutor(8) as tp:
        list(tp.map(_loadz, range(1, len(files))))
    return out


def _create_data(root, inputs, out_path):
    h5py = _h5py()

    raw = _load_volume(os.path.join(root, inputs[0]))
    labels_argb = _load_volume(os.path.join(root, inputs[1]))
    assert labels_argb.ndim == 4
    labels = np.zeros(raw.shape, dtype="int8")
    fg_mask = (labels_argb == np.array([255, 255, 255])[None, None, None]).all(axis=-1)
    labels[fg_mask] = 1
    bg_mask = (labels_argb == np.array([2, 2, 2])[None, None, None]).all(axis=-1)
    labels[bg_mask] = -1  # -1 marks empty area
    with h5py.File(out_path, "w") as f:
        f.create_dataset("raw", data=raw, compression="gzip")
        f.create_dataset("labels", data=labels, compression="gzip")


def get_kasthuri_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the Kasthuri data."""
    if os.path.exists(path) and glob(os.path.join(path, "*.h5")):
        return path
    os.makedirs(path, exist_ok=True)
    tmp_path = os.path.join(path, "kasthuri.zip")
    util.download_source(tmp_path, URL, download, checksum=CHECKSUM)
    util.unzip(tmp_path, path, remove=True)
    root = os.path.join(path, "Kasthuri++")
    assert os.path.exists(root), root
    inputs = [["Test_In", "Test_Out"], ["Train_In", "Train_Out"]]
    outputs = ["kasthuri_train.h5", "kasthuri_test.h5"]
    for inp, out in zip(inputs, outputs):
        _create_data(root, inp, os.path.join(path, out))
    rmtree(root)
    return path


def get_kasthuri_paths(path: Union[os.PathLike, str], split: str, download: bool = False) -> str:
    """Get the path to the Kasthuri data."""
    get_kasthuri_data(path, download)
    return os.path.join(path, f"kasthuri_{split}.h5")


def get_kasthuri_dataset(path: Union[os.PathLike, str], split: str,
                         patch_shape: Tuple[int, int, int], download: bool = False, **kwargs):
    """Get the Kasthuri dataset for mitochondria segmentation."""
    assert split in ("train", "test")
    data_path = get_kasthuri_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(data_path, "raw", data_path, "labels",
                                        patch_shape, **kwargs)


def get_kasthuri_loader(path: Union[os.PathLike, str], split: str,
                        patch_shape: Tuple[int, int, int], batch_size: int,
                        download: bool = False, **kwargs) -> DataLoader:
    """Get the Kasthuri data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_kasthuri_dataset(path, split, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
