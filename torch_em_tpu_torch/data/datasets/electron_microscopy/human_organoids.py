"""Human organoids dataset: organelle segmentation in cryo-ET of human
intestinal organoids (reference
torch_em/data/datasets/electron_microscopy/human_organoids.py).

EMPIAR-11380; publication: https://doi.org/10.1016/j.devcel.2023.03.001
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from ....utils.medical_io import load_mrc
from .. import util

ORGANELLES = ("mitos", "nuclei", "actin", "entotic_cell", "junctions")


def _prepare_dataset(data_root):
    """Merge each raw mrc volume with its per-organelle label mrcs into one
    h5 file (keys: 'raw' + one per organelle)."""
    h5py = _h5py()

    for raw_path in glob(os.path.join(data_root, "*bin2.mrc")):
        vol_path = Path(raw_path).with_suffix(".h5")
        if os.path.exists(vol_path):
            continue
        raw = np.asarray(load_mrc(raw_path))
        label_paths = [p for p in glob(raw_path.replace(".mrc", "*.mrc")) if p != raw_path]
        labels = {}
        for label_path in label_paths:
            label_name = Path(label_path).stem.split("_")[-1]
            if label_name == "cell":  # one outlier naming case
                label_name = "entotic_cell"
            labels[label_name] = np.asarray(load_mrc(label_path))
        chunks = tuple(min(c, s) for c, s in zip((8, 128, 128), raw.shape))
        with h5py.File(vol_path, "w") as f:
            f.create_dataset("raw", data=raw, chunks=chunks, compression="gzip")
            for lname, lvol in labels.items():
                f.create_dataset(lname, data=lvol, chunks=chunks, compression="gzip")
        os.remove(raw_path)
        for p in label_paths:
            os.remove(p)


def get_human_organoids_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the human organoids data (EMPIAR-11380)."""
    data_path = util.download_source_empiar(path, "11380", download)
    _prepare_dataset(data_path)
    return data_path


def get_human_organoids_paths(path: Union[os.PathLike, str], organelle: str,
                              download: bool = False) -> List[str]:
    """Get paths to the volumes that carry labels for the given organelle."""
    h5py = _h5py()

    assert organelle in ORGANELLES, \
        f"'{organelle}' does not match the available choices {ORGANELLES}."
    data_path = get_human_organoids_data(path, download)
    vol_paths = []
    for p in glob(os.path.join(data_path, "*.h5")):
        with h5py.File(p, "r") as f:
            if organelle in f:
                vol_paths.append(p)
    assert vol_paths, f"No volumes with '{organelle}' labels found."
    return vol_paths


def get_human_organoids_dataset(path: Union[os.PathLike, str], organelle: str,
                                patch_shape, download: bool = False, **kwargs):
    """Get the human organoids dataset for one organelle."""
    vol_paths = get_human_organoids_paths(path, organelle, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(vol_paths, "raw", vol_paths, organelle,
                                        patch_shape, **kwargs)


def get_human_organoids_loader(path: Union[os.PathLike, str], organelle: str,
                               patch_shape, batch_size: int, download: bool = False,
                               **kwargs) -> DataLoader:
    """Get the human organoids data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_human_organoids_dataset(path, organelle, patch_shape, download=download,
                                     **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
