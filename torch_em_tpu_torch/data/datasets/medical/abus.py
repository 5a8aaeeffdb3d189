"""ABUS dataset: breast tumor segmentation in ultrasound (MT-Small)
(reference torch_em/data/datasets/medical/abus.py).

Located at https://www.kaggle.com/datasets/mohammedtgadallah/mt-small-dataset;
publication: https://doi.org/10.1371/journal.pone.0251899
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util


def get_abus_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the ABUS (MT-Small) data (kaggle)."""
    data_dir = os.path.join(path, "MT_Small_Dataset")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(path, "mohammedtgadallah/mt-small-dataset", download)
    util.unzip(os.path.join(path, "mt-small-dataset.zip"), path)
    return data_dir


def get_abus_paths(path: Union[os.PathLike, str], category: str = "benign",
                   image_choice: str = "raw",
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the ABUS images and tumor masks
    (category 'benign'/'malign'; image_choice 'raw'/'fuzzy')."""
    data_dir = get_abus_data(path, download)
    if image_choice not in ("raw", "fuzzy"):
        raise ValueError(f"Invalid input choice: {image_choice}")
    if category not in ("benign", "malign"):
        raise ValueError(f"Invalid tumor category: {category}")
    cname = "Benign" if category == "benign" else "Malignant"
    raw_iname = f"Original_{cname}" if image_choice == "raw" else f"Fuzzy_{cname}"
    image_paths = util.natsorted(glob(os.path.join(data_dir, cname, raw_iname, "*.png")))
    gt_paths = util.natsorted(glob(os.path.join(data_dir, cname, f"Ground_Truth_{cname}", "*.png")))
    assert len(image_paths) and len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_abus_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     category: str = "benign", image_choice: str = "raw",
                     resize_inputs: bool = False, download: bool = False, **kwargs):
    """Get the ABUS dataset for breast tumor segmentation."""
    image_paths, gt_paths = get_abus_paths(path, category, image_choice, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_abus_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                    batch_size: int, category: str = "benign", image_choice: str = "raw",
                    resize_inputs: bool = False, download: bool = False,
                    **kwargs) -> DataLoader:
    """Get the ABUS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_abus_dataset(path, patch_shape, category=category, image_choice=image_choice,
                          resize_inputs=resize_inputs, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
