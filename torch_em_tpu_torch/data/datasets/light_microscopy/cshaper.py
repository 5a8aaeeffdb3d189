"""CShaper dataset: cell segmentation in C. elegans embryo membrane stacks
(reference torch_em/data/datasets/light_microscopy/cshaper.py).

The zip must be downloaded manually from
https://doi.org/10.6084/m9.figshare.12839315.
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from ....utils.medical_io import load_nifti
from .. import util

_ZIP_ROOT = "CShaper Supplementary Data/DMapNet Training and Evaluation"


def get_cshaper_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Extract the manually downloaded CShaper zip."""
    data_dir = os.path.join(path, _ZIP_ROOT)
    if os.path.exists(data_dir):
        return data_dir
    zips = glob(os.path.join(path, "*.zip"))
    if not zips:
        raise RuntimeError(
            f"No zip file found in {path}; download the CShaper data manually from "
            "https://doi.org/10.6084/m9.figshare.12839315."
        )
    util.unzip(zips[0], path)
    return data_dir


def _convert_to_h5(data_dir, split):
    h5py = _h5py()

    split_subdir = "TrainingData" if split == "train" else "EvaluationData"
    split_dir = os.path.join(data_dir, split_subdir)
    h5_dir = os.path.join(data_dir, f"h5_{split}")
    if os.path.exists(h5_dir) and glob(os.path.join(h5_dir, "*.h5")):
        return h5_dir
    os.makedirs(h5_dir, exist_ok=True)
    for sample_dir in util.natsorted(
            [d for d in glob(os.path.join(split_dir, "*/")) if os.path.isdir(d)]):
        seg_dir = os.path.join(sample_dir, "SegCell")
        for raw_path in util.natsorted(glob(os.path.join(sample_dir, "RawMemb", "*.nii.gz"))):
            tp_stem = os.path.basename(raw_path).replace("_rawMemb.nii.gz", "")
            h5_path = os.path.join(h5_dir, f"{tp_stem}.h5")
            if os.path.exists(h5_path):
                continue
            seg_path = os.path.join(seg_dir, f"{tp_stem}_segCell.nii.gz")
            if not os.path.exists(seg_path):
                continue
            raw = np.asarray(load_nifti(raw_path))
            labels = np.asarray(load_nifti(seg_path))
            with h5py.File(h5_path, "w") as f:
                f.create_dataset("raw", data=raw, compression="gzip")
                f.create_dataset("labels", data=labels.astype("int64"), compression="gzip")
    return h5_dir


def get_cshaper_paths(path: Union[os.PathLike, str], split: str = "train",
                      download: bool = False) -> List[str]:
    """Get paths to the CShaper volumes for a split ('train' / 'val')."""
    assert split in ("train", "val"), f"Invalid split: {split}"
    data_dir = get_cshaper_data(path, download)
    h5_dir = _convert_to_h5(data_dir, split)
    h5_files = util.natsorted(glob(os.path.join(h5_dir, "*.h5")))
    assert len(h5_files) > 0
    return h5_files


def get_cshaper_dataset(path: Union[os.PathLike, str], patch_shape, split: str = "train",
                        download: bool = False, **kwargs):
    """Get the CShaper dataset for cell segmentation."""
    paths = get_cshaper_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape, **kwargs)


def get_cshaper_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                       split: str = "train", download: bool = False, **kwargs) -> DataLoader:
    """Get the CShaper data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_cshaper_dataset(path, patch_shape, split=split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
