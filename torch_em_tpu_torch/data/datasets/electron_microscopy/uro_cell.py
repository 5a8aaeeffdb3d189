"""UroCell dataset for organelle segmentation in FIB-SEM (reference
torch_em/data/datasets/electron_microscopy/uro_cell.py).

Publication: https://doi.org/10.1016/j.compbiomed.2020.103693. The NIfTI volumes are read by the
port's own reader (``utils/medical_io.load_nifti``), with no nibabel: float64 in (X, Y, Z) order,
as ``nibabel.load(path).get_fdata()`` gives them.
"""

import os
import warnings
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from ....utils.medical_io import load_nifti
from .. import util

URL = "https://github.com/MancaZerovnikMekuc/UroCell/archive/refs/heads/master.zip"
CHECKSUM = "a48cf31b06114d7def642742b4fcbe76103483c069122abe10f377d71a1acabc"


def _get_fdata(path):
    """A NIfTI volume as ``nibabel.load(path).get_fdata()`` gives it: scaled, float64, (X, Y, Z)."""
    return load_nifti(path, apply_scaling=True).astype("float64")


def get_uro_cell_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the UroCell data and convert the nifti volumes to h5."""
    h5py = _h5py()

    if os.path.exists(path) and glob(os.path.join(path, "*.h5")):
        return path

    os.makedirs(path, exist_ok=True)
    tmp_path = os.path.join(path, "uro_cell.zip")
    util.download_source(tmp_path, URL, download, checksum=CHECKSUM)
    util.unzip(tmp_path, path, remove=True)

    root = os.path.join(path, "UroCell-master")
    files = sorted(glob(os.path.join(root, "data", "*.nii.gz")))
    for data_path in files:
        fname = os.path.basename(data_path)
        data = _get_fdata(data_path)
        out_path = os.path.join(path, fname.replace("nii.gz", "h5"))
        with h5py.File(out_path, "w") as f:
            f.create_dataset("raw", data=data, compression="gzip")
            for label_name in ("fv", "golgi", "lyso", "mito"):
                label_path = os.path.join(root, label_name, "instance", fname)
                if os.path.exists(label_path):
                    labels = _get_fdata(label_path).astype("uint32")
                    f.create_dataset(f"labels/{label_name}", data=labels, compression="gzip")
    return path


def get_uro_cell_paths(path: Union[os.PathLike, str], target: str,
                       download: bool = False) -> List[str]:
    """Get paths to UroCell volumes that have labels for the given target."""
    h5py = _h5py()

    get_uro_cell_data(path, download)
    all_paths = sorted(glob(os.path.join(path, "*.h5")))
    paths = []
    for p in all_paths:
        with h5py.File(p, "r") as f:
            if f"labels/{target}" in f:
                paths.append(p)
    assert paths, f"No volumes with labels for {target} found."
    return paths


def get_uro_cell_dataset(
    path: Union[os.PathLike, str],
    target: str,
    patch_shape: Tuple[int, int, int],
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    **kwargs,
):
    """Get the UroCell dataset for organelle segmentation."""
    assert target in ("fv", "golgi", "lyso", "mito")
    paths = get_uro_cell_paths(path, target, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=binary, binary=binary, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(paths, "raw", paths, f"labels/{target}",
                                        patch_shape, **kwargs)


def get_uro_cell_loader(
    path: Union[os.PathLike, str],
    target: str,
    patch_shape: Tuple[int, int, int],
    batch_size: int,
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    **kwargs,
) -> DataLoader:
    """Get the UroCell data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_uro_cell_dataset(
        path, target, patch_shape, download=download, offsets=offsets,
        boundaries=boundaries, binary=binary, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
