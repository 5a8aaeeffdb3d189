"""m2caiSeg dataset: organ/instrument segmentation in laparoscopy frames
(reference torch_em/data/datasets/medical/m2caiseg.py).

Located at https://www.kaggle.com/datasets/salmanmaq/m2caiseg;
publication: https://doi.org/10.48550/arXiv.2008.10134
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

LABEL_MAPS = {
    (0, 0, 0): 0, (0, 85, 170): 1, (0, 85, 255): 2, (0, 170, 255): 3, (0, 255, 85): 4,
    (0, 255, 170): 5, (85, 0, 170): 6, (85, 0, 255): 7, (170, 85, 85): 8, (170, 170, 170): 9,
    (85, 170, 0): 10, (85, 170, 255): 11, (85, 255, 0): 12, (85, 255, 170): 13,
    (170, 0, 255): 14, (255, 0, 255): 15, (255, 255, 0): 16, (255, 0, 0): 17, (170, 0, 85): 18,
}


def get_m2caiseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the m2caiSeg data (kaggle)."""
    data_dir = os.path.join(path, "m2caiSeg dataset")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(path, "salmanmaq/m2caiseg", download)
    util.unzip(os.path.join(path, "m2caiseg.zip"), path)
    return data_dir


def get_m2caiseg_paths(path: Union[os.PathLike, str], split: str,
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the m2caiSeg frames and (rgb->id converted) masks; the
    val split is the trainval remainder not in train."""
    Image = _pil_image()

    data_dir = get_m2caiseg_data(path, download)
    if split == "val":
        imids = {os.path.split(p)[-1] for p in
                 glob(os.path.join(data_dir, "train", "images", "*.jpg"))}
        gids = {os.path.split(p)[-1] for p in
                glob(os.path.join(data_dir, "train", "groundtruth", "*.png"))}
        image_paths = [p for p in util.natsorted(
            glob(os.path.join(data_dir, "trainval", "images", "*.jpg")))
            if os.path.split(p)[-1] not in imids]
        gt_paths = [p for p in util.natsorted(
            glob(os.path.join(data_dir, "trainval", "groundtruth", "*.png")))
            if os.path.split(p)[-1] not in gids]
    else:
        image_paths = util.natsorted(glob(os.path.join(data_dir, split, "images", "*.jpg")))
        gt_paths = util.natsorted(glob(os.path.join(data_dir, split, "groundtruth", "*.png")))

    images_dir = os.path.join(data_dir, "preprocessed", split, "images")
    mask_dir = os.path.join(data_dir, "preprocessed", split, "masks")
    if os.path.exists(images_dir) and os.path.exists(mask_dir):
        return (util.natsorted(glob(os.path.join(images_dir, "*"))),
                util.natsorted(glob(os.path.join(mask_dir, "*"))))
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)

    fimage_paths, fgt_paths = [], []
    for image_path, gt_path in zip(image_paths, gt_paths):
        image = np.asarray(load_image(image_path))
        gt = np.asarray(load_image(gt_path))
        if image.shape != gt.shape:
            continue
        dst_image_path = os.path.join(images_dir, f"{Path(image_path).stem}.tif")
        dst_gt_path = os.path.join(mask_dir, f"{Path(gt_path).stem}.tif")
        fimage_paths.append(dst_image_path)
        fgt_paths.append(dst_gt_path)
        if os.path.exists(dst_gt_path) and os.path.exists(dst_image_path):
            continue
        instances = np.zeros(gt.shape[:2], dtype="uint8")
        for lmap, idx in LABEL_MAPS.items():
            instances[(gt == lmap).all(axis=2)] = idx
        Image.fromarray(image).save(dst_image_path)
        Image.fromarray(instances).save(dst_gt_path)
    return fimage_paths, fgt_paths


def get_m2caiseg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         split: str, resize_inputs: bool = False,
                         download: bool = False, **kwargs):
    """Get the m2caiSeg dataset."""
    image_paths, gt_paths = get_m2caiseg_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_m2caiseg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        batch_size: int, split: str, resize_inputs: bool = False,
                        download: bool = False, **kwargs) -> DataLoader:
    """Get the m2caiSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_m2caiseg_dataset(path, patch_shape, split, resize_inputs=resize_inputs,
                              download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
