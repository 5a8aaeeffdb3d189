"""DCA1 X-ray coronary angiogram vessel segmentation (reference
torch_em/data/datasets/medical/dca1.py).

Publication: https://doi.org/10.3390/app9245507
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "http://personal.cimat.mx:8181/~ivan.cruz/DB_Angiograms_files/DB_Angiograms_134.zip"
CHECKSUM = "7161638a6e92c6a6e47a747db039292c8a1a6bad809aac0d1fd16a10a6f22a11"


def get_dca1_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the DCA1 data."""
    data_dir = os.path.join(path, "Database_134_Angiograms")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "DB_Angiograms_134.zip")
    util.download_source(zip_path, URL, download=download, checksum=CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_dca1_paths(path: Union[os.PathLike, str], split: str,
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the DCA1 images and vessel masks."""
    data_dir = get_dca1_data(path, download)
    image_paths, gt_paths = [], []
    for image_path in sorted(glob(os.path.join(data_dir, "*.pgm"))):
        if image_path.endswith("_gt.pgm"):
            gt_paths.append(image_path)
        else:
            image_paths.append(image_path)
    # split: train = first 100, val = next 17, test = rest (reference convention)
    if split == "train":
        image_paths, gt_paths = image_paths[:100], gt_paths[:100]
    elif split == "val":
        image_paths, gt_paths = image_paths[100:117], gt_paths[100:117]
    elif split == "test":
        image_paths, gt_paths = image_paths[117:], gt_paths[117:]
    else:
        raise ValueError(f"'{split}' is not a valid split.")
    return image_paths, gt_paths


def get_dca1_dataset(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int],
    split: str,
    resize_inputs: bool = False,
    download: bool = False,
    **kwargs,
):
    """Get the DCA1 dataset for vessel segmentation."""
    image_paths, gt_paths = get_dca1_paths(path, split, download)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(
        image_paths, None, gt_paths, None, patch_shape, is_seg_dataset=False, ndim=2, **kwargs,
    )


def get_dca1_loader(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int],
    batch_size: int,
    split: str,
    resize_inputs: bool = False,
    download: bool = False,
    **kwargs,
) -> DataLoader:
    """Get the DCA1 data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_dca1_dataset(path, patch_shape, split, resize_inputs=resize_inputs,
                          download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
