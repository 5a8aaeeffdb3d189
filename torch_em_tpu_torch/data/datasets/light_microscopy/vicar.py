"""VICAR dataset: cell segmentation in quantitative phase imaging
(reference torch_em/data/datasets/light_microscopy/vicar.py).

Located at https://zenodo.org/record/5153251.
"""

import os
from glob import glob
from typing import List, Optional, Sequence, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = {
    "labelled": "https://zenodo.org/record/5153251/files/labelled.zip",
    "unlabelled": "https://zenodo.org/record/5153251/files/unlabelled.zip",
}
CHECKSUMS = {
    "labelled": "e4b6fc8ad3955c4e0fe0e95a9be03d4333b6d9029f675ae9652084cefc4aaab6",
    "unlabelled": "c0228c56140d16141a5f9fb303080861624d6d2d25fab5bd463e489dab9adf4b",
}
VALID_CELL_TYPES = ["A2058", "G361", "HOB", "PC3", "PNT1A"]


def get_vicar_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the (labelled) VICAR data."""
    data_dir = os.path.join(path, "labelled")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "labelled.zip")
    util.download_source(zip_path, URL["labelled"], download, CHECKSUMS["labelled"])
    util.unzip(zip_path, data_dir)
    return data_dir


def get_vicar_paths(path: Union[os.PathLike, str],
                    cell_types: Optional[Sequence[str]] = None,
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the VICAR images and masks, optionally per cell type."""
    data_dir = get_vicar_data(path, download)
    if cell_types is None:
        cell_types = VALID_CELL_TYPES
    elif isinstance(cell_types, str):
        cell_types = [cell_types]
    raw_paths, label_paths = [], []
    for cell_type in cell_types:
        assert cell_type in VALID_CELL_TYPES, f"Invalid cell type: {cell_type}"
        raw_paths.extend(util.natsorted(glob(os.path.join(data_dir, cell_type, "*_img.tif"))))
        label_paths.extend(util.natsorted(glob(os.path.join(data_dir, cell_type, "*_mask.png"))))
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_vicar_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                      cell_types: Optional[Sequence[str]] = None,
                      download: bool = False, **kwargs):
    """Get the VICAR dataset for cell segmentation."""
    raw_paths, label_paths = get_vicar_paths(path, cell_types, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_vicar_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     batch_size: int, cell_types: Optional[Sequence[str]] = None,
                     download: bool = False, **kwargs) -> DataLoader:
    """Get the VICAR data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_vicar_dataset(path, patch_shape, cell_types=cell_types,
                           download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
