"""CellSeg3d dataset: nucleus segmentation in 3D fluorescence (mesoSPIM)
volumes (reference torch_em/data/datasets/light_microscopy/cellseg_3d.py).

Publication: https://doi.org/10.1101/2024.05.17.594691
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/11095111/files/DATASET_WITH_GT.zip?download=1"
CHECKSUM = "6d8e8d778e479000161fdfea70201a6ded95b3958a703f69def63e69bbddf9d6"


def get_cellseg_3d_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the CellSeg3d data."""
    data_root = os.path.join(path, "DATASET_WITH_GT")
    if os.path.exists(data_root):
        return data_root
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "cellseg3d.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path, True)
    return data_root


def get_cellseg_3d_paths(path: Union[os.PathLike, str],
                         download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the CellSeg3d volumes and labels."""
    data_root = get_cellseg_3d_data(path, download)
    raw_paths = sorted(glob(os.path.join(data_root, "*.tif")))
    label_paths = sorted(glob(os.path.join(data_root, "labels", "*.tif")))
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_cellseg_3d_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                           sample_ids: Optional[Tuple[int, ...]] = None,
                           download: bool = False, **kwargs):
    """Get the CellSeg3d dataset for 3D nucleus segmentation."""
    raw_paths, label_paths = get_cellseg_3d_paths(path, download)
    if sample_ids is not None:
        assert all(sid < len(raw_paths) for sid in sample_ids)
        raw_paths = [raw_paths[i] for i in sample_ids]
        label_paths = [label_paths[i] for i in sample_ids]
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_cellseg_3d_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                          batch_size: int, sample_ids: Optional[Tuple[int, ...]] = None,
                          download: bool = False, **kwargs) -> DataLoader:
    """Get the CellSeg3d data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_cellseg_3d_dataset(path, patch_shape, sample_ids=sample_ids,
                                download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
