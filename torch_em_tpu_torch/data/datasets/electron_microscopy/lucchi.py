"""Lucchi mitochondria segmentation dataset (reference
torch_em/data/datasets/electron_microscopy/lucchi.py).

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

URL = "http://www.casser.io/files/lucchi_pp.zip"
CHECKSUM = "770ce9e98fc6f29c1b1a250c637e6c5125f2b5f1260e5a7687b55a79e2e8844d"


def _load_volume(path, pattern):
    Image = _pil_image()

    files = sorted(glob(os.path.join(path, "*.png")))
    nz = len(files)
    im0 = np.asarray(Image.open(os.path.join(path, pattern % 0)))
    out = np.zeros((nz,) + im0.shape, dtype=im0.dtype)
    out[0] = im0

    def _loadz(z):
        out[z] = np.asarray(Image.open(os.path.join(path, pattern % z)))

    with futures.ThreadPoolExecutor(8) as tp:
        list(tp.map(_loadz, range(1, nz)))
    return out


def _create_data(root, inputs, out_path):
    h5py = _h5py()

    raw = _load_volume(os.path.join(root, inputs[0]), pattern="mask%04i.png")
    labels_argb = _load_volume(os.path.join(root, inputs[1]), pattern="%i.png")
    if labels_argb.ndim == 4:
        labels = np.zeros(raw.shape, dtype="uint8")
        fg_mask = (labels_argb == np.array([255, 255, 255, 255])[None, None, None]).all(axis=-1)
        labels[fg_mask] = 1
    else:
        labels = labels_argb
        labels[labels == 255] = 1
    assert raw.shape == labels.shape, f"{raw.shape}, {labels.shape}"
    with h5py.File(out_path, "w") as f:
        f.create_dataset("raw", data=raw, compression="gzip")
        f.create_dataset("labels", data=labels.astype("uint8"), compression="gzip")


def get_lucchi_data(path: Union[os.PathLike, str], split: str, download: bool = False) -> str:
    """Download the Lucchi dataset."""
    data_path = os.path.join(path, f"lucchi_{split}.h5")
    if os.path.exists(data_path):
        return data_path
    os.makedirs(path, exist_ok=True)
    tmp_path = os.path.join(path, "lucchi.zip")
    util.download_source(tmp_path, URL, download, checksum=CHECKSUM)
    util.unzip(tmp_path, path, remove=True)
    root = os.path.join(path, "Lucchi++")
    assert os.path.exists(root), root
    inputs = [["Test_In", "Test_Out"], ["Train_In", "Train_Out"]]
    outputs = ["lucchi_train.h5", "lucchi_test.h5"]
    for inp, out in zip(inputs, outputs):
        _create_data(root, inp, os.path.join(path, out))
    rmtree(root)
    assert os.path.exists(data_path), data_path
    return data_path


def get_lucchi_paths(path: Union[os.PathLike, str], split: str, download: bool = False) -> str:
    """Get the path to the Lucchi data."""
    get_lucchi_data(path, split, download)
    return os.path.join(path, f"lucchi_{split}.h5")


def get_lucchi_dataset(path: Union[os.PathLike, str], split: str,
                       patch_shape: Tuple[int, int, int], download: bool = False, **kwargs):
    """Get the Lucchi dataset for mitochondria segmentation."""
    assert split in ("train", "test")
    data_path = get_lucchi_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(data_path, "raw", data_path, "labels",
                                        patch_shape, **kwargs)


def get_lucchi_loader(path: Union[os.PathLike, str], split: str,
                      patch_shape: Tuple[int, int, int], batch_size: int,
                      download: bool = False, **kwargs) -> DataLoader:
    """Get the Lucchi data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_lucchi_dataset(path, split, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
