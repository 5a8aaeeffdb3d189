"""CURVAS dataset: pancreas, kidney and liver segmentation in CT with
multi-rater annotations (reference torch_em/data/datasets/medical/curvas.py).

Challenge: https://curvas.grand-challenge.org; located at
https://zenodo.org/records/12687192.
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.medical_io import load_nifti
from .. import util
from ....utils.io import _h5py

URL = "https://zenodo.org/records/12687192/files/training_set.zip"
CHECKSUM = "1126a2205553ae1d4fe5fbaee7ea732aacc4f5a92b96504ed521c23e5a0e3f89"


def _preprocess_data(data_dir):
    """Convert the per-patient nifti volumes into h5 files carrying the CT
    and the three raters' annotations."""
    h5py = _h5py()

    for image_path in util.natsorted(glob(os.path.join(data_dir, "*", "image.nii.gz"))):
        pdir = os.path.dirname(image_path)
        out_path = os.path.join(pdir, "data.h5")
        if os.path.exists(out_path):
            continue
        raw = np.asarray(load_nifti(image_path)).transpose(2, 0, 1)
        with h5py.File(out_path, "w") as f:
            chunks = (8,) + raw.shape[1:]
            f.create_dataset("raw", data=raw, compression="gzip", chunks=chunks)
            for i in (1, 2, 3):
                rater = np.rint(np.asarray(load_nifti(
                    os.path.join(pdir, f"annotation_{i}.nii.gz")))).astype("uint8").transpose(2, 0, 1)
                f.create_dataset(f"labels/rater_{i}", data=rater, compression="gzip",
                                 chunks=chunks)


def get_curvas_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the CURVAS data."""
    data_dir = os.path.join(path, "training_set")
    if not os.path.exists(data_dir):
        os.makedirs(path, exist_ok=True)
        zip_path = os.path.join(path, "training_set.zip")
        util.download_source(zip_path, URL, download, CHECKSUM)
        util.unzip(zip_path, path)
    _preprocess_data(data_dir)
    return data_dir


def get_curvas_paths(path: Union[os.PathLike, str], download: bool = False) -> List[str]:
    """Get paths to the CURVAS volumes."""
    data_dir = get_curvas_data(path, download)
    return util.natsorted(glob(os.path.join(data_dir, "*", "data.h5")))


def get_curvas_dataset(path: Union[os.PathLike, str], patch_shape, rater: str = "1",
                       download: bool = False, **kwargs):
    """Get the CURVAS dataset for abdominal organ segmentation."""
    assert rater in ("1", "2", "3"), f"Invalid rater: {rater}"
    paths = get_curvas_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, f"labels/rater_{rater}",
                                        patch_shape, **kwargs)


def get_curvas_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                      rater: str = "1", download: bool = False, **kwargs) -> DataLoader:
    """Get the CURVAS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_curvas_dataset(path, patch_shape, rater=rater, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
