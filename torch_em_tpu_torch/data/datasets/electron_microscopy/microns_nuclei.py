"""MICrONS nuclei dataset: crops of EM data with annotated nuclei from mouse
cortex (reference torch_em/data/datasets/electron_microscopy/microns_nuclei.py).

Extracted from https://doi.org/10.1038/s41586-025-08790-w (the MICrONS cubic
millimeter); please cite it if you use this dataset.
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://owncloud.gwdg.de/index.php/s/ToLGAzg1FAV4Sxf/download"
CHECKSUM = "36afcc963aea597faf991f6844537d2330739a89aa05c1a91fea31f2b4dc2de4"


def get_microns_nuclei_data(path: Union[os.PathLike, str], split: str, download: bool) -> str:
    """Download the MICrONS nuclei data; returns the split folder."""
    assert split in ("train", "val", "test")
    split_folder = os.path.join(str(path), split)
    if not os.path.exists(split_folder):
        os.makedirs(str(path), exist_ok=True)
        zip_path = os.path.join(str(path), "microns_nucleus_data.zip")
        util.download_source(zip_path, URL, download, CHECKSUM)
        util.unzip(zip_path, str(path), remove=True)
    return split_folder


def get_microns_nuclei_paths(path: Union[os.PathLike, str], split: str, download: bool) -> List[str]:
    """Get paths to the MICrONS nuclei h5 crops for a split."""
    split_folder = get_microns_nuclei_data(path, split, download)
    return sorted(glob(os.path.join(split_folder, "*.h5")))


def get_microns_nuclei_dataset(path: Union[os.PathLike, str], split: str,
                               patch_shape: Tuple[int, int, int],
                               download: bool = False, **kwargs):
    """Dataset for nucleus segmentation in EM (keys: raw, labels/nuclei)."""
    paths = get_microns_nuclei_paths(path, split, download)
    return default_segmentation_dataset(
        raw_paths=paths, raw_key="raw",
        label_paths=paths, label_key="labels/nuclei",
        patch_shape=patch_shape, is_seg_dataset=True, **kwargs,
    )


def get_microns_nuclei_loader(path: Union[os.PathLike, str], split: str,
                              patch_shape: Tuple[int, int, int], batch_size: int,
                              download: bool = False, **kwargs) -> DataLoader:
    """DataLoader for nucleus segmentation in EM."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_microns_nuclei_dataset(path, split, patch_shape, download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
