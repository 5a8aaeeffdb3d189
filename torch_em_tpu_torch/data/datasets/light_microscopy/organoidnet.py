"""OrganoIDNet dataset: organoid segmentation in brightfield microscopy
(reference torch_em/data/datasets/light_microscopy/organoidnet.py).

Publication: https://doi.org/10.1007/s13402-024-00958-2
"""

import os
import shutil
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/10643410/files/OrganoIDNetData.zip?download=1"
CHECKSUM = "3cd9239bf74bda096ecb5b7bdb95f800c7fa30b9937f9aba6ddf98d754cbfa3d"
SPLITS = ("Training", "Validation", "Test")


def get_organoidnet_data(path: Union[os.PathLike, str], split: str,
                         download: bool = False) -> str:
    """Download the OrganoIDNet data for a split
    ('Training' / 'Validation' / 'Test')."""
    assert split in SPLITS, f"Invalid split: {split}"
    data_dir = os.path.join(path, split)
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "OrganoIDNetData.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    for dl_split in SPLITS:
        src = os.path.join(path, "OrganoIDNetData", "Dataset", dl_split)
        if os.path.exists(src):
            shutil.move(src, os.path.join(path, dl_split))
    extracted = os.path.join(path, "OrganoIDNetData")
    if os.path.exists(extracted):
        shutil.rmtree(extracted)
    return data_dir


def get_organoidnet_paths(path: Union[os.PathLike, str], split: str,
                          download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the OrganoIDNet images and instance labels."""
    data_dir = get_organoidnet_data(path, split, download)
    image_paths = sorted(glob(os.path.join(data_dir, "Images", "*.tif")))
    label_paths = sorted(glob(os.path.join(data_dir, "Masks", "*.tif")))
    assert len(image_paths) == len(label_paths)
    return image_paths, label_paths


def get_organoidnet_dataset(path: Union[os.PathLike, str], split: str,
                            patch_shape: Tuple[int, int], download: bool = False, **kwargs):
    """Get the OrganoIDNet dataset for organoid segmentation."""
    image_paths, label_paths = get_organoidnet_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(image_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_organoidnet_loader(path: Union[os.PathLike, str], split: str,
                           patch_shape: Tuple[int, int], batch_size: int,
                           download: bool = False, **kwargs) -> DataLoader:
    """Get the OrganoIDNet data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_organoidnet_dataset(path, split, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
