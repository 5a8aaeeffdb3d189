"""NucMorph dataset: 3D nucleus segmentation in hiPSC colonies (Allen
Institute nuc-morph release; reference
torch_em/data/datasets/light_microscopy/nuc_morph.py).

Per-FOV tifs are streamed from the public allencell S3 bucket; a manifest
csv provides the train (372) / val (20) / test (18) split.
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

S3_BASE = (
    "https://allencell.s3.amazonaws.com/aics/nuc-morph-dataset/"
    "hipsc_nuclei_image_datasets_for_training_deep_learning_models/"
    "segmentation_decoder_training_fov_dataset"
)
VALID_SPLITS = ("train", "val", "test")


def _get_split_indices(path, split):
    import pandas as pd

    manifest_path = os.path.join(path, "training_data_manifest.csv")
    if not os.path.exists(manifest_path):
        util.download_source(manifest_path, f"{S3_BASE}/training_data_manifest.csv", True)
    df = pd.read_csv(manifest_path)
    manifest_split = "valid" if split == "val" else split  # manifest says 'valid'
    return sorted(df[df["mode"] == manifest_split].iloc[:, 0].tolist())


def _download_files(path, split, download):
    raw_dir = os.path.join(path, "high_res_100x")
    seg_dir = os.path.join(path, "watershed_segmentation_100x")
    os.makedirs(raw_dir, exist_ok=True)
    os.makedirs(seg_dir, exist_ok=True)
    for idx in _get_split_indices(path, split):
        fname = f"IMG_{idx:04d}.tif"
        raw_path = os.path.join(raw_dir, fname)
        if not os.path.exists(raw_path):
            util.download_source(raw_path, f"{S3_BASE}/high_res_100x/{fname}", download)
        seg_path = os.path.join(seg_dir, fname)
        if not os.path.exists(seg_path):
            util.download_source(
                seg_path, f"{S3_BASE}/watershed_segmentation_100x/{fname}", download)


def _create_h5_data(path, split):
    h5py = _h5py()

    h5_dir = os.path.join(path, "h5_data", split)
    os.makedirs(h5_dir, exist_ok=True)
    for idx in _get_split_indices(path, split):
        fname = f"IMG_{idx:04d}"
        h5_path = os.path.join(h5_dir, f"{fname}.h5")
        if os.path.exists(h5_path):
            continue
        raw = np.asarray(load_image(os.path.join(path, "high_res_100x", f"{fname}.tif")))
        seg = np.asarray(load_image(
            os.path.join(path, "watershed_segmentation_100x", f"{fname}.tif")))
        with h5py.File(h5_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=seg.astype("int64"), compression="gzip")
    return h5_dir


def get_nuc_morph_data(path: Union[os.PathLike, str], split: str = "train",
                       download: bool = False) -> str:
    """Download the NucMorph data for a split and convert it to h5."""
    assert split in VALID_SPLITS, f"'{split}' is not a valid split."
    os.makedirs(path, exist_ok=True)
    h5_dir = os.path.join(path, "h5_data", split)
    if os.path.exists(h5_dir) and glob(os.path.join(h5_dir, "*.h5")):
        return h5_dir
    _download_files(path, split, download)
    return _create_h5_data(path, split)


def get_nuc_morph_paths(path: Union[os.PathLike, str], split: str = "train",
                        download: bool = False) -> List[str]:
    """Get paths to the NucMorph h5 volumes."""
    h5_dir = get_nuc_morph_data(path, split, download)
    h5_paths = util.natsorted(glob(os.path.join(h5_dir, "*.h5")))
    assert len(h5_paths) > 0
    return h5_paths


def get_nuc_morph_dataset(path: Union[os.PathLike, str], patch_shape,
                          split: str = "train", download: bool = False, **kwargs):
    """Get the NucMorph dataset for 3D nucleus segmentation."""
    h5_paths = get_nuc_morph_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(h5_paths, "raw", h5_paths, "labels",
                                        patch_shape, is_seg_dataset=True, **kwargs)


def get_nuc_morph_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                         split: str = "train", download: bool = False,
                         **kwargs) -> DataLoader:
    """Get the NucMorph data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_nuc_morph_dataset(path, patch_shape, split=split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
