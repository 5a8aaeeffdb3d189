"""PNAS Arabidopsis dataset: cell segmentation in confocal stacks of the
Arabidopsis shoot apical meristem (reference
torch_em/data/datasets/light_microscopy/pnas_arabidopsis.py).

From the publication https://doi.org/10.1073/pnas.1616768113.
"""

import os
import shutil
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URL = "https://www.repository.cam.ac.uk/bitstream/handle/1810/262530/PNAS.zip?sequence=4&isAllowed=y"
CHECKSUM = "39341398389baf6d93c3f652b7e2e8aedc5579c29dfaf2b82b41ebfc3caa05c4"


def get_pnas_arabidopsis_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the PNAS Arabidopsis data and convert it to per-stack h5."""
    h5py = _h5py()

    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir) and glob(os.path.join(data_dir, "*.h5")):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "PNAS.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, data_dir)

    raw_paths = util.natsorted(glob(os.path.join(
        data_dir, "PNAS", "plant*", "processed_tiffs", "*trim-acylYFP.tif")))
    for rpath in raw_paths:
        label_path = glob(rpath.replace("processed_tiffs", "segmentation_tiffs")
                          .replace(".tif", "*.tif"))
        if len(label_path) != 1:  # a few stacks have no matching labels
            continue
        raw = np.asarray(load_image(rpath))
        labels = np.asarray(load_image(label_path[0]))
        vol_path = os.path.join(data_dir, str(Path(os.path.basename(rpath)).with_suffix(".h5")))
        with h5py.File(vol_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=labels, compression="gzip")
    shutil.rmtree(os.path.join(data_dir, "PNAS"))
    return data_dir


def get_pnas_arabidopsis_paths(path: Union[os.PathLike, str],
                               download: bool = False) -> List[str]:
    """Get paths to the PNAS Arabidopsis h5 volumes."""
    data_dir = get_pnas_arabidopsis_data(path, download)
    return glob(os.path.join(data_dir, "*.h5"))


def get_pnas_arabidopsis_dataset(path: Union[os.PathLike, str],
                                 patch_shape: Tuple[int, ...],
                                 download: bool = False, **kwargs):
    """Get the PNAS Arabidopsis dataset for cell segmentation."""
    volume_paths = get_pnas_arabidopsis_paths(path, download)
    return default_segmentation_dataset(volume_paths, "raw", volume_paths, "labels",
                                        patch_shape, is_seg_dataset=True, **kwargs)


def get_pnas_arabidopsis_loader(path: Union[os.PathLike, str],
                                patch_shape: Tuple[int, ...], batch_size: int,
                                download: bool = False, **kwargs) -> DataLoader:
    """Get the PNAS Arabidopsis data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_pnas_arabidopsis_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
