"""PhMamm dataset: cell segmentation in light-sheet microscopy of
Phallusia mammillata embryos (reference
torch_em/data/datasets/light_microscopy/phmamm.py).

Hosted at https://figshare.com/articles/dataset/3D_Mask_R-CNN_data/26973085;
original data from https://doi.org/10.1126/science.aar5663 (ASTEC).
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URLS = {
    "inputs": "https://ndownloader.figshare.com/files/51130115",
    "ground_truth": "https://ndownloader.figshare.com/files/51130100",
}


def get_phmamm_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the PhMamm images and ASTEC ground truth."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    inputs_zip = os.path.join(path, "Inputs.zip")
    util.download_source(inputs_zip, URLS["inputs"], download)
    util.unzip(inputs_zip, data_dir)
    gt_zip = os.path.join(path, "ASTEC_Ground_truth.zip")
    util.download_source(gt_zip, URLS["ground_truth"], download)
    util.unzip(gt_zip, data_dir)
    return data_dir


def get_phmamm_paths(path: Union[os.PathLike, str],
                     download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the PhMamm volumes and labels."""
    data_dir = get_phmamm_data(path, download)
    raw_paths = util.natsorted(glob(os.path.join(data_dir, "Inputs", "*.tiff")))
    label_paths = util.natsorted(glob(os.path.join(data_dir, "ASTEC_Ground_truth", "*.tiff")))
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_phmamm_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                       offsets: Optional[List[List[int]]] = None,
                       boundaries: bool = False, binary: bool = False,
                       download: bool = False, **kwargs):
    """Get the PhMamm dataset for 3D cell segmentation."""
    raw_paths, label_paths = get_phmamm_paths(path, download)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, offsets=offsets, boundaries=boundaries, binary=binary,
    )
    return default_segmentation_dataset(raw_paths, None, label_paths, None,
                                        patch_shape, **kwargs)


def get_phmamm_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                      batch_size: int, offsets: Optional[List[List[int]]] = None,
                      boundaries: bool = False, binary: bool = False,
                      download: bool = False, **kwargs) -> DataLoader:
    """Get the PhMamm data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_phmamm_dataset(path, patch_shape, offsets=offsets, boundaries=boundaries,
                            binary=binary, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
