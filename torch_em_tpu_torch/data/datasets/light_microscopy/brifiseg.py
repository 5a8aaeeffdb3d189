"""BriFiSeg dataset: nucleus segmentation in brightfield images
(reference torch_em/data/datasets/light_microscopy/brifiseg.py).

Located at https://zenodo.org/records/7195636;
publication: https://doi.org/10.48550/arXiv.2211.03072
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

URL = "https://zenodo.org/records/7195636/files/1channel.tar"
CHECKSUM = "2be173c265ab737957dd6c007cc51a5ad528087d23cecc53b211cf4dcc7727fa"


def _preprocess(path, data_dir):
    h5py = _h5py()

    raw_paths = util.natsorted(glob(os.path.join(path, "1channel", "Task*", "images*", "*.nii.gz")))
    label_paths = util.natsorted(glob(os.path.join(path, "1channel", "Task*", "labels*", "*.nii.gz")))
    # images follow the nnUNet naming (<name>_0000); align with labels
    label_by_name = {os.path.basename(p).split(".")[0]: p for p in label_paths}
    for rpath in raw_paths:
        fname = os.path.basename(rpath).split(".")[0]
        base = fname[:-5] if fname.endswith("_0000") else fname
        lpath = label_by_name.get(base)
        if lpath is None:
            continue
        split = "train" if os.path.basename(os.path.dirname(lpath)) == "labelsTr" else "test"
        os.makedirs(os.path.join(data_dir, split), exist_ok=True)
        out_path = os.path.join(data_dir, split, f"{base}.h5")
        if os.path.exists(out_path):
            continue
        raw = np.asarray(load_nifti(rpath)).squeeze()
        labels = np.asarray(load_nifti(lpath)).squeeze()
        with h5py.File(out_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=labels, compression="gzip")


def get_brifiseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and convert the BriFiSeg data."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    tar_path = os.path.join(path, "1channel.tar")
    util.download_source(tar_path, URL, download, CHECKSUM)
    util.unzip_tarfile(tar_path, path)
    for zip_path in glob(os.path.join(path, "1channel", "*.zip")):
        util.unzip(zip_path, os.path.join(path, "1channel"))
    _preprocess(path, data_dir)
    return data_dir


def get_brifiseg_paths(path: Union[os.PathLike, str], split: str,
                       download: bool = False) -> List[str]:
    """Get paths to the BriFiSeg volumes for a split ('train' / 'test')."""
    assert split in ("train", "test"), f"Invalid split: {split}"
    data_dir = get_brifiseg_data(path, download)
    return util.natsorted(glob(os.path.join(data_dir, split, "*.h5")))


def get_brifiseg_dataset(path: Union[os.PathLike, str], patch_shape, split: str,
                         download: bool = False, **kwargs):
    """Get the BriFiSeg dataset for nucleus segmentation."""
    paths = get_brifiseg_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape,
                                        ndim=2, **kwargs)


def get_brifiseg_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                        split: str, download: bool = False, **kwargs) -> DataLoader:
    """Get the BriFiSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_brifiseg_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
