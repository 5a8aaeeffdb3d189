"""HepG2 spheroids dataset: 3D nucleus instance segmentation in densely
packed carcinoma spheroids (reference
torch_em/data/datasets/light_microscopy/spheroids_hepg2.py).

Located at https://ndownloader.figshare.com/files/30449889.
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://ndownloader.figshare.com/files/30449889"
CHECKSUM = None


def get_spheroids_hepg2_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the HepG2 spheroids data."""
    if os.path.exists(os.path.join(path, "GT")):
        return path
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "12spheroids.zip")
    util.download_source(zip_path, URL, download, checksum=CHECKSUM)
    util.unzip(zip_path, path)
    return path


def get_spheroids_hepg2_paths(path: Union[os.PathLike, str],
                              download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the spheroid volumes (.nrrd) and GT instances."""
    data_dir = get_spheroids_hepg2_data(path, download)
    raw_paths = util.natsorted([
        p for p in glob(os.path.join(data_dir, "spheroids", "*.nrrd"))
        if "expanded" not in os.path.basename(p)
    ])
    label_paths = util.natsorted([
        p for p in glob(os.path.join(data_dir, "GT", "*.nrrd"))
        if "expanded" not in os.path.basename(p)
    ])
    if len(raw_paths) == 0:
        raise RuntimeError(f"No image files found in {os.path.join(data_dir, 'spheroids')}.")
    if len(raw_paths) != len(label_paths):
        raise RuntimeError(
            f"Images ({len(raw_paths)}) and labels ({len(label_paths)}) do not match.")
    return raw_paths, label_paths


def get_spheroids_hepg2_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                                download: bool = False, **kwargs):
    """Get the HepG2 spheroids dataset."""
    raw_paths, label_paths = get_spheroids_hepg2_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_spheroids_hepg2_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                               batch_size: int, download: bool = False,
                               **kwargs) -> DataLoader:
    """Get the HepG2 spheroids data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_spheroids_hepg2_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
