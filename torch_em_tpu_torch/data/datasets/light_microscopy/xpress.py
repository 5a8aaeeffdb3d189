"""XPRESS dataset: neuron segmentation in X-ray holographic nano-tomography
(reference torch_em/data/datasets/light_microscopy/xpress.py).

Challenge: https://xpress.grand-challenge.org/.
"""

import os
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

URLS = {
    "raw": "https://github.com/htem/xpress-challenge-files/releases/download/v1.0/xpress-training-raw.h5",
    "labels": "https://github.com/htem/xpress-challenge-files/releases/download/v1.0/xpress-training-voxel-labels.h5",
}


def _merge_to_single_h5(raw_path, label_path, out_path):
    """Crop the raw around the labeled region (+128 px context) and store raw
    + zero-padded labels in one h5 file."""
    if os.path.exists(out_path):
        return out_path
    h5py = _h5py()

    with h5py.File(raw_path, "r") as fr, h5py.File(label_path, "r") as fl, \
            h5py.File(out_path, "w") as fo:
        raw_ds_in = fr["volumes/raw"]
        labels_ds_in = fl["volumes/labels"]
        raw_resolution = np.array(raw_ds_in.attrs.get("resolution", [1, 1, 1]))
        label_offset = np.array(labels_ds_in.attrs.get("offset", [0, 0, 0]))
        voxel_offset = (label_offset / raw_resolution).astype(int)
        labels_arr = labels_ds_in[...]

        context_pad = 128
        raw_shape = np.array(raw_ds_in.shape)
        starts = np.clip(voxel_offset - context_pad, 0, raw_shape)
        ends = np.clip(voxel_offset + np.array(labels_arr.shape) + context_pad, 0, raw_shape)
        raw_arr = raw_ds_in[tuple(slice(int(s), int(e)) for s, e in zip(starts, ends))]

        label_insert_offset = voxel_offset - starts
        padded_labels = np.zeros(raw_arr.shape, dtype="int64")
        padded_labels[tuple(
            slice(int(o), int(o) + s) for o, s in zip(label_insert_offset, labels_arr.shape)
        )] = labels_arr

        chunks = tuple(min(64, int(s)) for s in raw_arr.shape)
        fo.create_dataset("raw", data=raw_arr, chunks=chunks, compression="gzip")
        fo.create_dataset("labels", data=padded_labels, chunks=chunks, compression="gzip")
    return out_path


def get_xpress_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the XPRESS training data and merge it into one h5."""
    merged_path = os.path.join(path, "xpress-training.h5")
    if os.path.exists(merged_path):
        return merged_path
    os.makedirs(path, exist_ok=True)
    raw_path = os.path.join(path, "xpress-training-raw.h5")
    label_path = os.path.join(path, "xpress-training-voxel-labels.h5")
    util.download_source(raw_path, URLS["raw"], download, checksum=None)
    util.download_source(label_path, URLS["labels"], download, checksum=None)
    return _merge_to_single_h5(raw_path, label_path, merged_path)


def get_xpress_paths(path: Union[os.PathLike, str], download: bool = False) -> List[str]:
    """Get the path to the merged XPRESS volume."""
    return [get_xpress_data(path, download)]


def get_xpress_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                       download: bool = False, **kwargs):
    """Get the XPRESS dataset for neuron segmentation."""
    paths = get_xpress_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape, **kwargs)


def get_xpress_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                      batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the XPRESS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_xpress_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
