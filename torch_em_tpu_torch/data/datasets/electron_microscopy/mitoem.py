"""MitoEM mitochondria segmentation benchmark (reference
torch_em/data/datasets/electron_microscopy/mitoem.py).

Two EM volumes (rat, human) with 3D mitochondria instance labels.
Publication: https://doi.org/10.1007/978-3-030-59722-1_7
"""

import multiprocessing
import os
from concurrent import futures
from shutil import rmtree
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, _pil_image
from .. import util

URLS = {
    "raw": {
        "human": "https://huggingface.co/datasets/pytc/MitoEM/resolve/main/EM30-H-im.zip",
        "rat": "https://huggingface.co/datasets/pytc/MitoEM/resolve/main/EM30-R-im.zip",
    },
    "labels": {
        "human": "https://huggingface.co/datasets/pytc/MitoEM/resolve/main/EM30-H-mito-train-val-v2.zip",
        "rat": "https://huggingface.co/datasets/pytc/MitoEM/resolve/main/EM30-R-mito-train-val-v2.zip",
    },
}
CHECKSUMS = {
    "raw": {"human": None, "rat": None},
    "labels": {"human": None, "rat": None},
}


def _slices_to_volume(im_folder, label_folder, out_path, split):
    h5py = _h5py()
    Image = _pil_image()

    z_ranges = {"train": (0, 400), "val": (400, 500)}
    z0, z1 = z_ranges[split]

    im_files = sorted(os.listdir(im_folder))[z0:z1]
    label_files = sorted(os.listdir(label_folder))

    raw = np.stack([np.asarray(Image.open(os.path.join(im_folder, f))) for f in im_files])
    labels = np.stack([
        np.asarray(Image.open(os.path.join(label_folder, f))) for f in label_files
    ])[z0:z1] if len(label_files) >= z1 else None

    with h5py.File(out_path, "w") as f:
        f.create_dataset("raw", data=raw, compression="gzip")
        if labels is not None:
            f.create_dataset("labels", data=labels.astype("uint32"), compression="gzip")


def get_mitoem_data(path: Union[os.PathLike, str], samples: Sequence[str],
                    splits: Sequence[str], download: bool) -> None:
    """Download the MitoEM data and convert the slice stacks to h5 volumes."""
    if isinstance(splits, str):
        splits = [splits]
    if isinstance(samples, str):
        samples = [samples]
    os.makedirs(path, exist_ok=True)
    for sample in samples:
        if all(os.path.exists(os.path.join(path, f"{sample}_{split}.h5")) for split in splits):
            continue
        raw_zip = os.path.join(path, f"{sample}_raw.zip")
        label_zip = os.path.join(path, f"{sample}_labels.zip")
        util.download_source(raw_zip, URLS["raw"][sample], download, CHECKSUMS["raw"][sample])
        util.download_source(label_zip, URLS["labels"][sample], download,
                             CHECKSUMS["labels"][sample])
        util.unzip(raw_zip, os.path.join(path, f"{sample}_raw"), remove=True)
        util.unzip(label_zip, os.path.join(path, f"{sample}_labels"), remove=True)
        im_folder = os.path.join(path, f"{sample}_raw", "im")
        label_folder = os.path.join(path, f"{sample}_labels", "mito-train-val-v2")
        for split in splits:
            _slices_to_volume(im_folder, label_folder,
                              os.path.join(path, f"{sample}_{split}.h5"), split)
        rmtree(os.path.join(path, f"{sample}_raw"), ignore_errors=True)
        rmtree(os.path.join(path, f"{sample}_labels"), ignore_errors=True)


def get_mitoem_paths(path: Union[os.PathLike, str], splits: Sequence[str],
                     samples: Sequence[str] = ("human", "rat"),
                     download: bool = False) -> List[str]:
    """Get paths to the MitoEM volumes."""
    if isinstance(splits, str):
        splits = [splits]
    if isinstance(samples, str):
        samples = [samples]
    get_mitoem_data(path, samples, splits, download)
    data_paths = [
        os.path.join(path, f"{sample}_{split}.h5") for sample in samples for split in splits
    ]
    for p in data_paths:
        assert os.path.exists(p), p
    return data_paths


def get_mitoem_dataset(
    path: Union[os.PathLike, str],
    splits: Sequence[str],
    patch_shape: Tuple[int, int, int],
    samples: Sequence[str] = ("human", "rat"),
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    **kwargs,
):
    """Get the MitoEM dataset for mitochondria segmentation."""
    assert len(patch_shape) == 3
    data_paths = get_mitoem_paths(path, splits, samples, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=binary, binary=binary, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(data_paths, "raw", data_paths, "labels",
                                        patch_shape, **kwargs)


def get_mitoem_loader(
    path: Union[os.PathLike, str],
    splits: Sequence[str],
    patch_shape: Tuple[int, int, int],
    batch_size: int,
    samples: Sequence[str] = ("human", "rat"),
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    **kwargs,
) -> DataLoader:
    """Get the MitoEM data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_mitoem_dataset(
        path, splits, patch_shape, samples=samples, download=download, offsets=offsets,
        boundaries=boundaries, binary=binary, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
