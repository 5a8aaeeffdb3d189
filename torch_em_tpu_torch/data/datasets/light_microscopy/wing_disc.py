"""Wing Disc dataset: 3D cell segmentation in Drosophila wing discs
(reference torch_em/data/datasets/light_microscopy/wing_disc.py).

Hosted at https://www.ebi.ac.uk/biostudies/BioImages/studies/S-BIAD843.
OME-Zarr volumes are converted to h5 with 'raw' and 'labels' (zarr access
through the port's own reader, ``utils/zarr_n5.py``, instead of the zarr-python package).
"""

import os
from glob import glob
from typing import List, Optional, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_data
from .. import util

BASE_URL = "https://ftp.ebi.ac.uk/biostudies/fire/S-BIAD/843/S-BIAD843/Files"
VOLUMES = {
    "WD1_15-02_WT_confocalonly": "confocal",
    "WD2.1_21-02_WT_confocalonly": "confocal",
    "WD1.1_17-03_WT_MP": "multiphoton",
    "WD3.2_21-03_WT_MP": "multiphoton",
}


def _preprocess_volumes(path, data_dir):
    h5py = _h5py()

    os.makedirs(data_dir, exist_ok=True)
    zarr_dir = os.path.join(path, "zarr")
    for name in VOLUMES:
        h5_path = os.path.join(data_dir, f"{name}.h5")
        if os.path.exists(h5_path):
            continue
        # raw has shape (1, 1, Z, Y, X), labels (Z, 1, 1, Y, X); squeeze both.
        raw = np.asarray(load_data(os.path.join(zarr_dir, f"{name}.zarr"), "0/0")[:]).squeeze()
        seg = np.asarray(
            load_data(os.path.join(zarr_dir, f"{name}_segmented.zarr"), "0/0")[:]
        ).squeeze().astype("uint32")
        assert raw.shape == seg.shape, f"Shape mismatch for {name}."
        with h5py.File(h5_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=seg, compression="gzip")


def get_wing_disc_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the wing disc OME-Zarr volumes and convert them to h5."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir) and len(glob(os.path.join(data_dir, "*.h5"))) == len(VOLUMES):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zarr_dir = os.path.join(path, "zarr")
    os.makedirs(zarr_dir, exist_ok=True)
    for name in VOLUMES:
        for suffix in ("", "_segmented"):
            zarr_path = os.path.join(zarr_dir, f"{name}{suffix}.zarr")
            if os.path.exists(zarr_path):
                continue
            zip_fname = f"{name}{suffix}.ome.zarr.zip"
            zip_path = os.path.join(path, zip_fname)
            util.download_source(zip_path, f"{BASE_URL}/{zip_fname}", download)
            util.unzip(zip_path, zarr_path)
    _preprocess_volumes(path, data_dir)
    return data_dir


def get_wing_disc_paths(path: Union[os.PathLike, str], download: bool = False) -> List[str]:
    """Get paths to the wing disc h5 volumes."""
    data_dir = get_wing_disc_data(path, download)
    data_paths = util.natsorted(glob(os.path.join(data_dir, "*.h5")))
    assert len(data_paths) > 0
    return data_paths


def get_wing_disc_dataset(path: Union[os.PathLike, str], patch_shape,
                          offsets: Optional[List[List[int]]] = None,
                          boundaries: bool = False, binary: bool = False,
                          download: bool = False, **kwargs):
    """Get the wing disc dataset for 3D cell segmentation."""
    data_paths = get_wing_disc_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, offsets=offsets, boundaries=boundaries, binary=binary,
    )
    return default_segmentation_dataset(data_paths, "raw", data_paths, "labels",
                                        patch_shape, ndim=3, **kwargs)


def get_wing_disc_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                         offsets: Optional[List[List[int]]] = None,
                         boundaries: bool = False, binary: bool = False,
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the wing disc data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_wing_disc_dataset(path, patch_shape, offsets=offsets, boundaries=boundaries,
                               binary=binary, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
