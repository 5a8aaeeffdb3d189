"""FIB-25 dataset: neuron segmentation in FIB-SEM of the drosophila optic
lobe (reference torch_em/data/datasets/electron_microscopy/fib25.py).

Hosted at https://github.com/google/ffn (GCS);
publication: https://doi.org/10.1073/pnas.1509820112
"""

import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

GCS_BUCKET = "https://storage.googleapis.com/ffn-flyem-fib25"

URLS = {
    "training_sample2": {
        "raw": f"{GCS_BUCKET}/training_sample2/grayscale_maps.h5",
        "labels": f"{GCS_BUCKET}/training_sample2/groundtruth.h5",
    },
    "validation_sample": {
        "raw": f"{GCS_BUCKET}/validation_sample/grayscale_maps.h5",
        "labels": f"{GCS_BUCKET}/validation_sample/groundtruth.h5",
    },
    "tstvol-520-1": {
        "raw": f"{GCS_BUCKET}/tstvol-520-1/raw.h5",
        "labels": f"{GCS_BUCKET}/tstvol-520-1/groundtruth.h5",
    },
}
CHECKSUMS = {
    "training_sample2": {
        "raw": "ea031c98ee2de778a9a3a1e6d410df5de73e4ac28022df8e7255d84e3394cafa",
        "labels": "fd508e7aee1fe51ac9ae0460db4a841d275236f013c1f2552314b4f21b1010ea",
    },
    "validation_sample": {
        "raw": "400ccb2a7268a3880c63656e0d794f8e6252e62031869455cc8caeef245b2a83",
        "labels": "2c5e31af0af5476bc9669b88d01a4570a26eb020799eaf6131aa75f2f7d92e98",
    },
    "tstvol-520-1": {
        "raw": "0667e701c8b4464003d8a6cb0cf9deb2aa79fb415ec51deeac92e5f9c67a5a66",
        "labels": "ae61ae78a9874eb35ae8e5ed29b4cbfe7bbd07a61789ddb70aef4deb2532eb4e",
    },
}
SAMPLES = list(URLS.keys())


def _apply_transforms(groundtruth_path):
    """Map the 'stack' supervoxel ids to neuron body ids via the
    'transforms' table and store the result as 'neuron_ids'."""
    h5py = _h5py()

    # a dataset over this file may hold it open for reading, and HDF5 refuses to open it for writing then
    with h5py.File(groundtruth_path, "r") as f:
        if "neuron_ids" in f:
            return
    with h5py.File(groundtruth_path, "a") as f:
        stack = f["stack"][:]
        transforms = f["transforms"][:]
        mapping = np.zeros(int(stack.max()) + 1, dtype=stack.dtype)
        for src, dst in transforms:
            mapping[src] = dst
        f.create_dataset("neuron_ids", data=mapping[stack], compression="gzip")


def get_fib25_data(path: Union[os.PathLike, str],
                   samples: Sequence[str] = ("training_sample2",),
                   download: bool = False):
    """Download the FIB-25 data for the given samples."""
    os.makedirs(path, exist_ok=True)
    for sample in samples:
        assert sample in URLS, f"Invalid sample: {sample}. Choose from {SAMPLES}."
        sample_dir = os.path.join(path, sample)
        os.makedirs(sample_dir, exist_ok=True)
        raw_path = os.path.join(sample_dir, "raw.h5")
        labels_path = os.path.join(sample_dir, "groundtruth.h5")
        util.download_source(raw_path, URLS[sample]["raw"], download,
                             CHECKSUMS[sample]["raw"])
        util.download_source(labels_path, URLS[sample]["labels"], download,
                             CHECKSUMS[sample]["labels"])
        _apply_transforms(labels_path)


def get_fib25_paths(path: Union[os.PathLike, str],
                    samples: Sequence[str] = ("training_sample2",),
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the FIB-25 volumes."""
    get_fib25_data(path, samples, download)
    raw_paths = [os.path.join(path, s, "raw.h5") for s in samples]
    label_paths = [os.path.join(path, s, "groundtruth.h5") for s in samples]
    return raw_paths, label_paths


def get_fib25_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                      samples: Sequence[str] = ("training_sample2",),
                      offsets: Optional[List[List[int]]] = None, boundaries: bool = False,
                      download: bool = False, **kwargs):
    """Get the FIB-25 dataset for neuron segmentation."""
    raw_paths, label_paths = get_fib25_paths(path, samples, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(raw_paths, "raw", label_paths, "neuron_ids",
                                        patch_shape, **kwargs)


def get_fib25_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                     batch_size: int, samples: Sequence[str] = ("training_sample2",),
                     offsets: Optional[List[List[int]]] = None, boundaries: bool = False,
                     download: bool = False, **kwargs) -> DataLoader:
    """Get the FIB-25 data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_fib25_dataset(path, patch_shape, samples=samples, offsets=offsets,
                           boundaries=boundaries, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
