"""JSRT dataset: lung / multi-organ segmentation in chest X-rays
(reference torch_em/data/datasets/medical/jsrt.py).

Publication: https://doi.org/10.2214/ajr.174.1.1740071
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = {
    "Segmentation01": "http://imgcom.jsrt.or.jp/imgcom/wp-content/uploads/2018/11/Segmentation01.zip",
    "Segmentation02": "http://imgcom.jsrt.or.jp/imgcom/wp-content/uploads/2019/07/segmentation02.zip",
}
CHECKSUM = {
    "Segmentation01": "ab1f26a910bc18eae170928e9f2d98512cc4dc8949bf6cd38b98a93398714fcf",
    "Segmentation02": "f1432af4fcbd69342cf1bf2ca3d0d43b9535cdc6b160b86191b5b67de2fdbf3c",
}
ZIP_PATH = {"Segmentation01": "Segmentation01.zip", "Segmentation02": "segmentation02.zip"}
DATA_DIR = {"Segmentation01": "Segmentation01", "Segmentation02": "segmentation02"}


def get_jsrt_data(path: Union[os.PathLike, str], choice: str, download: bool = False):
    """Download the JSRT data for one annotation set
    ('Segmentation01' / 'Segmentation02')."""
    assert choice in URL, f"Invalid choice: {choice}"
    data_dir = os.path.join(path, DATA_DIR[choice])
    if os.path.exists(data_dir):
        return
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, ZIP_PATH[choice])
    util.download_source(zip_path, URL[choice], download, CHECKSUM[choice])
    util.unzip(zip_path, path)


def get_jsrt_paths(path: Union[os.PathLike, str], split: str,
                   choice: Optional[str] = None,
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the JSRT images and segmentation masks."""
    assert split in ("train", "test"), f"Invalid split: {split}"
    choices = list(URL.keys()) if choice is None else [choice]
    image_paths, gt_paths = [], []
    for per_choice in choices:
        get_jsrt_data(path, per_choice, download)
        if per_choice == "Segmentation01":
            root_dir = os.path.join(path, Path(ZIP_PATH[per_choice]).stem, split)
            curr_images = sorted(glob(os.path.join(root_dir, "org", "*.png")))
            curr_gt = sorted(glob(os.path.join(root_dir, "label", "*.png")))
        else:
            root_dir = os.path.join(path, Path(ZIP_PATH[per_choice]).stem)
            curr_images = sorted(glob(os.path.join(root_dir, f"org_{split}", "*.bmp")))
            curr_gt = sorted(glob(os.path.join(root_dir, f"label_{split}", "*.png")))
        image_paths.extend(curr_images)
        gt_paths.extend(curr_gt)
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_jsrt_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     split: str, choice: Optional[str] = None,
                     resize_inputs: bool = False, download: bool = False, **kwargs):
    """Get the JSRT dataset for chest X-ray segmentation."""
    image_paths, gt_paths = get_jsrt_paths(path, split, choice, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_jsrt_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                    batch_size: int, split: str, choice: Optional[str] = None,
                    resize_inputs: bool = False, download: bool = False,
                    **kwargs) -> DataLoader:
    """Get the JSRT data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_jsrt_dataset(path, patch_shape, split, choice=choice,
                          resize_inputs=resize_inputs, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
