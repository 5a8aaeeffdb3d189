"""HIL ToothSeg dataset: tooth segmentation in panoramic dental X-rays
(reference torch_em/data/datasets/medical/hil_toothseg.py).

Publication: https://www.mdpi.com/1424-8220/21/9/3110
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = "https://hitl-public-datasets.s3.eu-central-1.amazonaws.com/Teeth+Segmentation.zip"
CHECKSUM = "3b628165a218a5e8d446d1313e6ecbe7cfc599a3d6418cd60b4fb78745becc2e"


def get_hil_toothseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the HIL ToothSeg data."""
    data_dir = os.path.join(path, "Teeth Segmentation PNG")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "Teeth_Segmentation.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_hil_toothseg_paths(path: Union[os.PathLike, str], split: str,
                           download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the HIL ToothSeg images and (color->instance converted)
    labels; 450/50/rest train/val/test slicing as in the reference."""
    Image = _pil_image()

    data_dir = get_hil_toothseg_data(path, download)
    image_paths = util.natsorted(glob(os.path.join(data_dir, "d2", "img", "*")))
    gt_paths = util.natsorted(glob(os.path.join(data_dir, "d2", "masks_machine", "*")))

    neu_gt_dir = os.path.join(data_dir, "preprocessed", "gt")
    os.makedirs(neu_gt_dir, exist_ok=True)
    neu_gt_paths = []
    for gt_path in gt_paths:
        neu_gt_path = os.path.join(neu_gt_dir, f"{Path(gt_path).stem}.tif")
        neu_gt_paths.append(neu_gt_path)
        if os.path.exists(neu_gt_path):
            continue
        rgb_gt = np.asarray(load_image(gt_path))
        if rgb_gt.ndim == 2:
            rgb_gt = np.stack([rgb_gt] * 3, axis=-1)
        incolors = np.unique(rgb_gt.reshape(-1, rgb_gt.shape[2]), axis=0)
        if np.array_equal(incolors[0], np.zeros(rgb_gt.shape[2], incolors.dtype)):
            incolors = incolors[1:]
        instances = np.zeros(rgb_gt.shape[:2], dtype="int32")
        for idx, cvalue in enumerate(incolors, start=1):
            instances[(rgb_gt == cvalue).all(axis=2)] = idx
        Image.fromarray(instances, mode="I").save(neu_gt_path)

    if split == "train":
        image_paths, neu_gt_paths = image_paths[:450], neu_gt_paths[:450]
    elif split == "val":
        image_paths, neu_gt_paths = image_paths[425:475], neu_gt_paths[425:475]
    elif split == "test":
        image_paths, neu_gt_paths = image_paths[475:], neu_gt_paths[475:]
    else:
        raise ValueError(f"{split} is not a valid split.")
    return image_paths, neu_gt_paths


def get_hil_toothseg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                             split: str, resize_inputs: bool = False,
                             download: bool = False, **kwargs):
    """Get the HIL ToothSeg dataset."""
    image_paths, gt_paths = get_hil_toothseg_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_hil_toothseg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                            batch_size: int, split: str, resize_inputs: bool = False,
                            download: bool = False, **kwargs) -> DataLoader:
    """Get the HIL ToothSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_hil_toothseg_dataset(path, patch_shape, split, resize_inputs=resize_inputs,
                                  download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
