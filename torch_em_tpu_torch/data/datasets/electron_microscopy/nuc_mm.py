"""NucMM dataset: nucleus segmentation in EM (mouse) and X-Ray (zebrafish)
(reference torch_em/data/datasets/electron_microscopy/nuc_mm.py).

Publication: https://doi.org/10.1007/978-3-030-87193-2_16
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

URL = "https://drive.google.com/drive/folders/1_4CrlYvzx0ITnGlJOHdgcTRgeSkm9wT8"


def _consolidate_split(image_folder, label_folder, output_folder):
    """Merge the per-split image/label h5 pairs into single files with
    'raw' and 'labels' datasets."""
    h5py = _h5py()

    os.makedirs(output_folder, exist_ok=True)
    image_files = sorted(glob(os.path.join(image_folder, "*.h5")))
    label_files = sorted(glob(os.path.join(label_folder, "*.h5")))
    assert len(image_files) == len(label_files)
    for image_file, label_file in zip(image_files, label_files):
        with h5py.File(image_file, "r") as f:
            raw = f["main"][:]
        with h5py.File(label_file, "r") as f:
            labels = f["main"][:]
        assert raw.shape == labels.shape
        with h5py.File(os.path.join(output_folder, os.path.basename(image_file)), "a") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=labels, compression="gzip")


def get_nuc_mm_data(path: Union[os.PathLike, str], sample: str, download: bool = False) -> str:
    """Download the NucMM data for one sample ('mouse' or 'zebrafish')."""
    assert sample in ("mouse", "zebrafish")
    sample_folder = os.path.join(path, sample)
    if os.path.exists(sample_folder):
        return sample_folder

    util.download_source_gdrive(path, URL, download, download_type="folder")
    input_folder = os.path.join(
        path, "Mouse (NucMM-M)" if sample == "mouse" else "Zebrafish (NucMM-Z)"
    )
    assert os.path.exists(input_folder), input_folder
    for split in ("train", "val"):
        _consolidate_split(
            os.path.join(input_folder, "Image", split),
            os.path.join(input_folder, "Label", split),
            os.path.join(sample_folder, split),
        )
    return sample_folder


def get_nuc_mm_paths(path: Union[os.PathLike, str], sample: str, split: str,
                     download: bool = False) -> List[str]:
    """Get paths to the NucMM volumes for a sample and split ('train' / 'val')."""
    get_nuc_mm_data(path, sample, download)
    return sorted(glob(os.path.join(path, sample, split, "*.h5")))


def get_nuc_mm_dataset(path: Union[os.PathLike, str], sample: str, split: str,
                       patch_shape: Tuple[int, int, int], download: bool = False, **kwargs):
    """Get the NucMM dataset for nucleus segmentation."""
    assert split in ("train", "val")
    paths = get_nuc_mm_paths(path, sample, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape, **kwargs)


def get_nuc_mm_loader(path: Union[os.PathLike, str], sample: str, split: str,
                      patch_shape: Tuple[int, int, int], batch_size: int,
                      download: bool = False, **kwargs) -> DataLoader:
    """Get the NucMM data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_nuc_mm_dataset(path, sample, split, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
