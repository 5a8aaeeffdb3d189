"""CholecSeg8k dataset: organ and instrument segmentation in endoscopy
(reference torch_em/data/datasets/medical/cholecseg8k.py).

Located at https://www.kaggle.com/datasets/newslab/cholecseg8k/data;
publication: https://doi.org/10.48550/arXiv.1602.03012
"""

import os
import shutil
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

LABEL_MAPS = {
    (255, 255, 255): 0,  # small white frame around the image
    (50, 50, 50): 0,     # background
    (11, 11, 11): 1,     # abdominal wall
    (21, 21, 21): 2,     # liver
    (13, 13, 13): 3,     # gastrointestinal tract
    (12, 12, 12): 4,     # fat
    (31, 31, 31): 5,     # grasper
    (23, 23, 23): 6,     # connective tissue
    (24, 24, 24): 7,     # blood
    (25, 25, 25): 8,     # cystic dust
    (32, 32, 32): 9,     # l-hook electrocautery
    (22, 22, 22): 10,    # gallbladder
    (33, 33, 33): 11,    # hepatic vein
    (5, 5, 5): 12,       # liver ligament
}


def get_cholecseg8k_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the CholecSeg8k data (kaggle)."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(path, "newslab/cholecseg8k", download)
    util.unzip(os.path.join(path, "cholecseg8k.zip"), data_dir)
    return data_dir


def get_cholecseg8k_paths(path: Union[os.PathLike, str], split: str,
                          download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the CholecSeg8k frames and converted masks; videos are
    split train (middle), val / test (outer pairs) as in the reference."""
    Image = _pil_image()

    data_dir = get_cholecseg8k_data(path, download)
    video_dirs = util.natsorted(glob(os.path.join(data_dir, "video*")))
    if split == "train":
        video_dirs = video_dirs[2:-2]
    elif split == "val":
        video_dirs = [video_dirs[1], video_dirs[-2]]
    elif split == "test":
        video_dirs = [video_dirs[0], video_dirs[-1]]
    else:
        raise ValueError(f"'{split}' is not a valid split.")

    ppdir = os.path.join(data_dir, "preprocessed", split)
    if os.path.exists(ppdir):
        return (util.natsorted(glob(os.path.join(ppdir, "images", "*"))),
                util.natsorted(glob(os.path.join(ppdir, "masks", "*"))))
    os.makedirs(os.path.join(ppdir, "images"), exist_ok=True)
    os.makedirs(os.path.join(ppdir, "masks"), exist_ok=True)

    image_paths, gt_paths = [], []
    for video_dir in video_dirs:
        org_image_paths = util.natsorted(glob(os.path.join(video_dir, "video*", "*_endo.png")))
        org_gt_paths = util.natsorted(
            glob(os.path.join(video_dir, "video*", "*_endo_watershed_mask.png")))
        for org_image_path, org_gt_path in zip(org_image_paths, org_gt_paths):
            image_id = os.path.split(org_image_path)[-1]
            image_path = os.path.join(ppdir, "images", image_id)
            gt_path = os.path.join(ppdir, "masks", str(Path(image_id).with_suffix(".tif")))
            image_paths.append(image_path)
            gt_paths.append(gt_path)
            if os.path.exists(image_path) and os.path.exists(gt_path):
                continue
            gt = np.asarray(load_image(org_gt_path))
            assert gt.ndim == 3
            if gt.shape[-1] != 3:  # some labels carry an all-255 4th channel
                gt = gt[..., :3]
            instances = np.zeros(gt.shape[:2], dtype="uint8")
            for lmap, idx in LABEL_MAPS.items():
                instances[(gt == lmap).all(axis=2)] = idx
            shutil.copy(org_image_path, image_path)
            Image.fromarray(instances).save(gt_path)
    return image_paths, gt_paths


def get_cholecseg8k_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                            split: str, resize_inputs: bool = False,
                            download: bool = False, **kwargs):
    """Get the CholecSeg8k dataset."""
    image_paths, gt_paths = get_cholecseg8k_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_cholecseg8k_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                           batch_size: int, split: str, resize_inputs: bool = False,
                           download: bool = False, **kwargs) -> DataLoader:
    """Get the CholecSeg8k data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_cholecseg8k_dataset(path, patch_shape, split, resize_inputs=resize_inputs,
                                 download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
