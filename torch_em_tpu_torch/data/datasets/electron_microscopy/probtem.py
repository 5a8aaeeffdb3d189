"""ProbTEM dataset: mitochondria segmentation in skeletal-muscle TEM
(reference torch_em/data/datasets/electron_microscopy/probtem.py).

From https://yoonlab.unist.ac.kr/index.php/research/mitochondria-tem-dataset/
(google-drive hosted).
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

PROBTEM_GDRIVE_FOLDER = "1n2ZqbJEHPyMB_6a6OTBBACt5Jct2PZJc"
PROBTEM_DATA_ROOT = "Deeppi-EM/mitoseg_deploy/datasets/Skeletal_muscle"


def _preprocess_probtem(raw_dir, label_dir, out_dir):
    h5py = _h5py()

    os.makedirs(out_dir, exist_ok=True)
    raw_paths = sorted(glob(os.path.join(raw_dir, "*.tif")) + glob(os.path.join(raw_dir, "*.tiff")))
    for rp in raw_paths:
        name = os.path.splitext(os.path.basename(rp))[0]
        out_path = os.path.join(out_dir, f"{name}.h5")
        if os.path.exists(out_path):
            continue
        raw = np.asarray(load_image(rp))
        if raw.ndim == 3:
            raw = raw[..., 0]
        lp = os.path.join(label_dir, f"{name.replace('x_', 'y_')}.png")
        if not os.path.exists(lp):
            continue
        labels = np.asarray(load_image(lp))
        if labels.ndim == 3:
            labels = labels[..., 0]
        labels = (labels >= 127).astype(np.uint8)
        with h5py.File(out_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=labels, compression="gzip")


def get_probtem_data(path: Union[os.PathLike, str], split: str = "train",
                     download: bool = False) -> str:
    """Download (gdrive folder) and preprocess the ProbTEM data."""
    assert split in ("train", "test"), f"Invalid split: {split}"
    processed_dir = os.path.join(str(path), "processed", split)
    if os.path.isdir(processed_dir) and glob(os.path.join(processed_dir, "*.h5")):
        return processed_dir
    raw_dir = os.path.join(str(path), PROBTEM_DATA_ROOT, split, "input")
    label_dir = os.path.join(str(path), PROBTEM_DATA_ROOT, split, "target")
    if not os.path.isdir(raw_dir):
        util.download_source_gdrive(
            str(path), f"https://drive.google.com/drive/folders/{PROBTEM_GDRIVE_FOLDER}",
            download, download_type="folder",
        )
    _preprocess_probtem(raw_dir, label_dir, processed_dir)
    return processed_dir


def get_probtem_paths(path: Union[os.PathLike, str], split: str = "train",
                      download: bool = False) -> List[str]:
    """Get paths to the ProbTEM volumes."""
    processed_dir = get_probtem_data(path, split, download)
    return sorted(glob(os.path.join(processed_dir, "*.h5")))


def get_probtem_dataset(path: Union[os.PathLike, str], patch_shape, split: str = "train",
                        download: bool = False, **kwargs):
    """Get the ProbTEM dataset for mitochondria segmentation."""
    paths = get_probtem_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape,
                                        ndim=2, **kwargs)


def get_probtem_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                       split: str = "train", download: bool = False, **kwargs) -> DataLoader:
    """Get the ProbTEM data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_probtem_dataset(path, patch_shape, split=split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
