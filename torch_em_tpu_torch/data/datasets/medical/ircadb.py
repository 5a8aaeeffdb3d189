"""3D-IRCADb dataset: liver (and other organ) segmentation in CT
(reference torch_em/data/datasets/medical/ircadb.py).

From https://www.ircad.fr/research/data-sets/; the DICOM series are read by the
port's own reader (``utils/dicom.py``), with no pydicom.
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util
from ....utils import dicom
from ....utils.io import _h5py

URL = "https://cloud.ircad.fr/index.php/s/JN3z7EynBiwYyjy/download"
CHECKSUM = None  # the server produces varying archives


def _preprocess_inputs(path):
    h5py = _h5py()

    data_dir = os.path.join(path, "Dataset")
    for pdir in glob(os.path.join(data_dir, "*")):
        patient_id = os.path.basename(pdir)
        vol_path = os.path.join(path, "data", f"{patient_id}.h5")
        if os.path.exists(vol_path):
            continue
        os.makedirs(os.path.join(path, "data"), exist_ok=True)
        images = np.stack([
            dicom.dcmread(p).pixel_array
            for p in util.natsorted(glob(os.path.join(pdir, "PATIENT_DICOM", "*")))
        ], axis=0)
        with h5py.File(vol_path, "w") as f:
            f.create_dataset("raw", data=images, compression="gzip")
            for mask_dir in glob(os.path.join(pdir, "MASKS_DICOM", "*")):
                organ = os.path.basename(mask_dir)
                labels = np.stack([
                    dicom.dcmread(p).pixel_array
                    for p in util.natsorted(glob(os.path.join(mask_dir, "*")))
                ], axis=0)
                f.create_dataset(f"labels/{organ}", data=labels, compression="gzip")


def get_ircadb_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the 3D-IRCADb data."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir) and glob(os.path.join(data_dir, "*.h5")):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "ircadb.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    _preprocess_inputs(path)
    return data_dir


def get_ircadb_paths(path: Union[os.PathLike, str], download: bool = False) -> List[str]:
    """Get paths to the 3D-IRCADb volumes."""
    data_dir = get_ircadb_data(path, download)
    return util.natsorted(glob(os.path.join(data_dir, "*.h5")))


def get_ircadb_dataset(path: Union[os.PathLike, str], patch_shape, organ: str = "liver",
                       download: bool = False, **kwargs):
    """Get the 3D-IRCADb dataset for one organ."""
    paths = get_ircadb_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, f"labels/{organ}",
                                        patch_shape, **kwargs)


def get_ircadb_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                      organ: str = "liver", download: bool = False, **kwargs) -> DataLoader:
    """Get the 3D-IRCADb data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_ircadb_dataset(path, patch_shape, organ=organ, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
