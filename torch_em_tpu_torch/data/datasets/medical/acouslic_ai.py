"""ACOUSLIC-AI dataset: fetal abdomen segmentation in prenatal ultrasound
(reference torch_em/data/datasets/medical/acouslic_ai.py).

Challenge: https://acouslic-ai.grand-challenge.org/
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/11005384/files/acouslic-ai-train-set.zip"
CHECKSUM = "187602dd243a3a872502b57b8ea56e28c67a9ded547b6e816b00c6d41f8b8767"


def get_acouslic_ai_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the ACOUSLIC-AI data."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "acouslic-ai-train-set.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, data_dir, remove=False)
    return data_dir


def get_acouslic_ai_paths(path: Union[os.PathLike, str],
                          download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the ACOUSLIC-AI volumes (.mha)."""
    data_dir = get_acouslic_ai_data(path, download)
    image_paths = util.natsorted(
        glob(os.path.join(data_dir, "images", "stacked_fetal_ultrasound", "*.mha")))
    gt_paths = util.natsorted(
        glob(os.path.join(data_dir, "masks", "stacked_fetal_abdomen", "*.mha")))
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_acouslic_ai_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                            resize_inputs: bool = False, download: bool = False, **kwargs):
    """Get the ACOUSLIC-AI dataset for fetal abdomen segmentation."""
    image_paths, gt_paths = get_acouslic_ai_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_acouslic_ai_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                           batch_size: int, resize_inputs: bool = False,
                           download: bool = False, **kwargs) -> DataLoader:
    """Get the ACOUSLIC-AI data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_acouslic_ai_dataset(path, patch_shape, resize_inputs=resize_inputs,
                                 download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
