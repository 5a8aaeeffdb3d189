"""FAFB nucleus dataset: nucleus segmentation in the full adult fly brain
EM volume (reference
torch_em/data/datasets/electron_microscopy/fafb_nuclei.py).

Extracted from https://doi.org/10.1101/2021.11.04.467197.
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://owncloud.gwdg.de/index.php/s/PDrkO02w7FWLrsh/download"
CHECKSUM = "7f245866fa8ffb473f7bda1fbbea23d265183e4ada5e34a36ecd60475809dca3"


def get_fafb_nuclei_data(path: Union[os.PathLike, str], split: str,
                         download: bool = False) -> str:
    """Download the FAFB nucleus data for a split ('train'/'val'/'test')."""
    assert split in ("train", "val", "test")
    split_folder = os.path.join(path, split)
    if not os.path.exists(split_folder):
        os.makedirs(path, exist_ok=True)
        zip_path = os.path.join(path, "fafb_nucleus_data.zip")
        util.download_source(zip_path, URL, download, CHECKSUM)
        util.unzip(zip_path, path, remove=True)
    return split_folder


def get_fafb_nuclei_paths(path: Union[os.PathLike, str], split: str,
                          download: bool = False) -> List[str]:
    """Get paths to the FAFB nucleus volumes."""
    split_folder = get_fafb_nuclei_data(path, split, download)
    return sorted(glob(os.path.join(split_folder, "*.h5")))


def get_fafb_nuclei_dataset(path: Union[os.PathLike, str], split: str,
                            patch_shape: Tuple[int, int, int],
                            download: bool = False, **kwargs):
    """Get the FAFB nucleus dataset."""
    paths = get_fafb_nuclei_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels/nuclei",
                                        patch_shape, **kwargs)


def get_fafb_nuclei_loader(path: Union[os.PathLike, str], split: str,
                           patch_shape: Tuple[int, int, int], batch_size: int,
                           download: bool = False, **kwargs) -> DataLoader:
    """Get the FAFB nucleus data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_fafb_nuclei_dataset(path, split, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
