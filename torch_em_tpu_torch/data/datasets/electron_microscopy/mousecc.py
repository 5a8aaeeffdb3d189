"""MouseCC dataset: intra-axonal space and myelin segmentation in 3D SEM of
the mouse corpus callosum genu (reference
torch_em/data/datasets/electron_microscopy/mousecc.py).

Requires manual download via
https://cai2r.net/resources/intra-axonal-space-segmented-from-3d-scanning-electron-microscopy-of-the-mouse-brain-genu-of-corpus-callosum/.
"""

import os
from typing import Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from ....utils.medical_io import load_nifti
from .. import util

MOUSECC_FILES = ("datac.nii", "maskc.nii", "myelin_mask.nii", "fibers.nii")
MOUSECC_DOWNLOAD_URL = (
    "https://cai2r.net/resources/"
    "intra-axonal-space-segmented-from-3d-scanning-electron-microscopy-"
    "of-the-mouse-brain-genu-of-corpus-callosum/"
)


def _convert_to_h5(path):
    h5py = _h5py()

    h5_path = os.path.join(str(path), "mousecc.h5")
    if os.path.exists(h5_path):
        return h5_path
    missing = [f for f in MOUSECC_FILES if not os.path.exists(os.path.join(str(path), f))]
    if missing:
        raise RuntimeError(
            f"MouseCC files not found in {path}: {missing}\n"
            f"This dataset requires manual download via {MOUSECC_DOWNLOAD_URL}; "
            "place datac.nii, maskc.nii, myelin_mask.nii, fibers.nii in the path directory.")

    def load_nii(fname, dtype):
        # NIfTI stores (x, y, z); move to the (z, y, x) convention.
        data = np.asarray(load_nifti(os.path.join(str(path), fname))).astype(dtype)
        return np.moveaxis(data, -1, 0)

    with h5py.File(h5_path, "w") as f:
        f.create_dataset("raw", data=load_nii("datac.nii", "uint8"), compression="gzip")
        f.create_dataset("labels/foreground", data=load_nii("maskc.nii", "uint8"),
                         compression="gzip")
        f.create_dataset("labels/myelin", data=load_nii("myelin_mask.nii", "uint8"),
                         compression="gzip")
        f.create_dataset("labels/fibers", data=load_nii("fibers.nii", "uint32"),
                         compression="gzip")
    return h5_path


def get_mousecc_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Convert the manually downloaded MouseCC NIfTI files to h5."""
    os.makedirs(str(path), exist_ok=True)
    if download:
        raise RuntimeError(
            "MouseCC requires manual download (registration form); see "
            f"{MOUSECC_DOWNLOAD_URL}.")
    return _convert_to_h5(path)


def get_mousecc_paths(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Get the path to the MouseCC h5 volume."""
    return get_mousecc_data(path, download)


def get_mousecc_dataset(path: Union[os.PathLike, str], patch_shape,
                        label_choice: str = "myelin",
                        download: bool = False, **kwargs):
    """Get the MouseCC dataset ('myelin' or 'fibers' labels)."""
    if label_choice not in ("myelin", "fibers"):
        raise ValueError(f"Invalid label_choice: '{label_choice}'.")
    h5_path = get_mousecc_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(h5_path, "raw", h5_path,
                                        f"labels/{label_choice}", patch_shape, **kwargs)


def get_mousecc_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                       label_choice: str = "myelin",
                       download: bool = False, **kwargs) -> DataLoader:
    """Get the MouseCC data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_mousecc_dataset(path, patch_shape, label_choice=label_choice,
                             download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
