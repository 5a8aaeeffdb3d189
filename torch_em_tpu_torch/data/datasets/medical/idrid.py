"""IDRiD dataset: retinal lesion and optic disc segmentation in fundus
images (reference torch_em/data/datasets/medical/idrid.py).

Located at
https://ieee-dataport.org/open-access/indian-diabetic-retinopathy-image-dataset-idrid;
publication: https://doi.org/10.1016/j.media.2019.101561
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

TASKS = {
    "microaneurysms": "1. Microaneurysms",
    "haemorrhages": "2. Haemorrhages",
    "hard_exudates": "3. Hard Exudates",
    "soft_exudates": "4. Soft Exudates",
    "optic_disc": "5. Optic Disc",
}


def get_idrid_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the IDRiD data (kaggle)."""
    data_dir = os.path.join(path, "data", "A.%20Segmentation")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(
        path, "aaryapatel98/indian-diabetic-retinopathy-image-dataset", download)
    zip_path = os.path.join(path, "indian-diabetic-retinopathy-image-dataset.zip")
    util.unzip(zip_path, os.path.join(path, "data"))
    return data_dir


def get_idrid_paths(path: Union[os.PathLike, str], split: str, task: str,
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the IDRiD images and per-task masks."""
    assert split in ("train", "test")
    assert task in TASKS
    data_dir = get_idrid_data(path, download)
    split_dir = "a. Training Set" if split == "train" else "b. Testing Set"
    gt_paths = sorted(glob(os.path.join(
        data_dir, "A. Segmentation", "2. All Segmentation Groundtruths", split_dir,
        TASKS[task], "*.tif")))
    image_dir = os.path.join(data_dir, "A. Segmentation", "1. Original Images", split_dir)
    image_paths = [os.path.join(image_dir, f"{Path(p).stem[:-3]}.jpg") for p in gt_paths]
    return image_paths, gt_paths


def get_idrid_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                      split: str, task: str = "optic_disc", resize_inputs: bool = False,
                      download: bool = False, **kwargs):
    """Get the IDRiD dataset."""
    image_paths, gt_paths = get_idrid_paths(path, split, task, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_idrid_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     batch_size: int, split: str, task: str = "optic_disc",
                     resize_inputs: bool = False, download: bool = False,
                     **kwargs) -> DataLoader:
    """Get the IDRiD data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_idrid_dataset(path, patch_shape, split, task=task, resize_inputs=resize_inputs,
                           download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
