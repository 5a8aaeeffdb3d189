"""BUSI breast-ultrasound tumor segmentation (reference
torch_em/data/datasets/medical/busi.py).

Publication: https://doi.org/10.1016/j.dib.2019.104863
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://scholar.cu.edu.eg/Dataset_BUSI.zip"
CHECKSUM = "b2ce09f6063a31a73f628b6a6ee1245187cbaec225e93e563735691d68654de7"


def get_busi_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the BUSI data."""
    data_dir = os.path.join(path, "Dataset_BUSI_with_GT")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "Dataset_BUSI.zip")
    util.download_source(zip_path, URL, download=download, checksum=CHECKSUM, verify=False)
    util.unzip(zip_path, path)
    return data_dir


def get_busi_paths(path: Union[os.PathLike, str], category: Optional[str] = None,
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the BUSI images and masks."""
    data_dir = get_busi_data(path, download)
    if category is None:
        category = "*"
    elif category not in ("normal", "benign", "malignant"):
        raise ValueError(f"'{category}' is not a valid category choice.")
    data_dir = os.path.join(data_dir, category)
    image_paths = sorted(glob(os.path.join(data_dir, r"*).png")))
    gt_paths = sorted(glob(os.path.join(data_dir, r"*)_mask.png")))
    return image_paths, gt_paths


def get_busi_dataset(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int],
    category: Optional[str] = None,
    resize_inputs: bool = False,
    download: bool = False,
    **kwargs,
):
    """Get the BUSI dataset for breast tumor segmentation."""
    image_paths, gt_paths = get_busi_paths(path, category, download)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(
        image_paths, None, gt_paths, None, patch_shape, is_seg_dataset=False, ndim=2, **kwargs,
    )


def get_busi_loader(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int],
    batch_size: int,
    category: Optional[str] = None,
    resize_inputs: bool = False,
    download: bool = False,
    **kwargs,
) -> DataLoader:
    """Get the BUSI data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_busi_dataset(path, patch_shape, category=category, resize_inputs=resize_inputs,
                          download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
