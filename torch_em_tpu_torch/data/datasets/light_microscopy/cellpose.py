"""Cellpose training data: generalist cell segmentation ('cyto' and 'cyto2'
sets) (reference torch_em/data/datasets/light_microscopy/cellpose.py).

The data must be downloaded manually from https://www.cellpose.org/dataset
(requires accepting the data agreement).
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

AVAILABLE_CHOICES = ("cyto", "cyto2")


def get_cellpose_data(path: Union[os.PathLike, str], split: str, choice: str = "cyto",
                      download: bool = False) -> str:
    """Unpack the manually downloaded Cellpose data."""
    assert choice in AVAILABLE_CHOICES, f"Invalid choice: {choice}"
    per_choice_dir = os.path.join(path, choice)
    if choice == "cyto":
        assert split in ("train", "test"), f"'{split}' is not a valid split in '{choice}'."
        zip_path = os.path.join(path, f"{split}.zip")
        data_dir = os.path.join(per_choice_dir, split)
    else:
        assert split == "train", f"'{split}' is not a valid split in '{choice}'."
        zip_path = os.path.join(path, "train_cyto2.zip")
        data_dir = os.path.join(per_choice_dir, "train_cyto2")
    if os.path.exists(data_dir):
        return data_dir
    if not os.path.exists(zip_path):
        raise NotImplementedError(
            "Automatic download is not possible for the Cellpose data; download it from "
            f"https://www.cellpose.org/dataset and place the zips at {path}."
        )
    util.unzip(zip_path, per_choice_dir, remove=False)
    return data_dir


def get_cellpose_paths(path: Union[os.PathLike, str], split: str, choice: str = "cyto",
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the Cellpose images and instance masks."""
    data_dir = get_cellpose_data(path, split, choice, download)
    image_paths = util.natsorted(glob(os.path.join(data_dir, "*_img.png")))
    gt_paths = util.natsorted(glob(os.path.join(data_dir, "*_masks.png")))
    assert len(image_paths) == len(gt_paths) and len(image_paths) > 0
    return image_paths, gt_paths


def get_cellpose_dataset(path: Union[os.PathLike, str], split: str, patch_shape,
                         choice: str = "cyto", download: bool = False, **kwargs):
    """Get the Cellpose dataset for cell segmentation."""
    image_paths, gt_paths = get_cellpose_paths(path, split, choice, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True,
                                        **kwargs)


def get_cellpose_loader(path: Union[os.PathLike, str], split: str, patch_shape,
                        batch_size: int, choice: str = "cyto", download: bool = False,
                        **kwargs) -> DataLoader:
    """Get the Cellpose data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_cellpose_dataset(path, split, patch_shape, choice=choice,
                              download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
