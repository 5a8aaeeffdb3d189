"""CartoCell dataset: cell segmentation in 3D epithelial cysts
(reference torch_em/data/datasets/light_microscopy/cartocell.py).

Hosted at https://data.mendeley.com/datasets/7gbkxgngpm/2.
"""

import os
import shutil
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://prod-dcd-datasets-cache-zipfiles.s3.eu-west-1.amazonaws.com/7gbkxgngpm-2.zip"
CHECKSUM = "ca3fc289e7b67febfc03cdd55fd791078f7527820c8dbcee0b98d03d993bb6f5"
DNAME = ("CartoCell, a high-content pipeline for accurate 3D image analysis, "
         "unveils cell morphology patterns in epithelial cysts")


def get_cartocell_data(path: Union[os.PathLike, str], download: bool = False):
    """Download the CartoCell dataset."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "cartocell.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    shutil.move(os.path.join(path, DNAME), data_dir)


def get_cartocell_paths(path: Union[os.PathLike, str],
                        split: Optional[str] = None, name: Optional[str] = None,
                        download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the CartoCell low-resolution image and label stacks."""
    get_cartocell_data(path, download)
    split = "" if split is None else split + "_"
    if name is None:
        name = "*"
    elif name == "MDCK-Hypoxia":
        raise ValueError(f"'{name}' has mismatching shapes for image and labels.")
    raw_paths = util.natsorted(glob(
        os.path.join(path, "data", f"low-resolution_{name}_{split}raw_images", "*")))
    # MDCK-Hypoxia inputs have mismatching input-label shapes.
    raw_paths = [p for p in raw_paths if "MDCK-Hypoxia" not in p]
    label_paths = [p.replace("raw", "label") for p in raw_paths]
    assert len(raw_paths) > 0 and len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_cartocell_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                          split: Optional[str] = None, name: Optional[str] = None,
                          download: bool = False, **kwargs):
    """Get the CartoCell dataset for 3D cell segmentation in cysts."""
    raw_paths, label_paths = get_cartocell_paths(path, split, name, download)
    return default_segmentation_dataset(raw_paths, None, label_paths, None,
                                        patch_shape, **kwargs)


def get_cartocell_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                         batch_size: int, split: Optional[str] = None,
                         name: Optional[str] = None, download: bool = False,
                         **kwargs) -> DataLoader:
    """Get the CartoCell data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_cartocell_dataset(path, patch_shape, split=split, name=name,
                               download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
