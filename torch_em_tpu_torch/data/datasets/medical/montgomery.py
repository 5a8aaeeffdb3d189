"""Montgomery County chest X-ray dataset: lung segmentation
(reference torch_em/data/datasets/medical/montgomery.py).

Publications: https://doi.org/10.1109/TMI.2013.2284099,
https://doi.org/10.1109/tmi.2013.2290491
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = "http://openi.nlm.nih.gov/imgs/collections/NLM-MontgomeryCXRSet.zip"
CHECKSUM = "54601e952315d8f67383e9202a6e145997ade429f54f7e0af44b4e158714f424"


def get_montgomery_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the Montgomery data."""
    data_dir = os.path.join(path, "MontgomerySet")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "NLM-MontgomeryCXRSet.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_montgomery_paths(path: Union[os.PathLike, str],
                         download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the Montgomery images and (merged) lung masks."""
    Image = _pil_image()

    data_dir = get_montgomery_data(path, download)
    gt_dir = os.path.join(data_dir, "ManualMask", "gt")
    image_paths = sorted(glob(os.path.join(data_dir, "CXR_png", "*.png")))

    if os.path.exists(gt_dir):
        gt_paths = sorted(glob(os.path.join(gt_dir, "*.png")))
        if len(image_paths) == len(gt_paths):
            return image_paths, gt_paths
    os.makedirs(gt_dir, exist_ok=True)

    lmask_dir = os.path.join(data_dir, "ManualMask", "leftMask")
    rmask_dir = os.path.join(data_dir, "ManualMask", "rightMask")
    gt_paths = []
    for image_path in image_paths:
        image_id = os.path.split(image_path)[-1]
        gt = np.asarray(load_image(os.path.join(lmask_dir, image_id))).astype("uint8")
        gt = gt + np.asarray(load_image(os.path.join(rmask_dir, image_id))).astype("uint8")
        gt_path = os.path.join(gt_dir, image_id)
        Image.fromarray(gt).save(gt_path)
        gt_paths.append(gt_path)
    return image_paths, gt_paths


def get_montgomery_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                           resize_inputs: bool = True, download: bool = False, **kwargs):
    """Get the Montgomery dataset for lung segmentation."""
    image_paths, gt_paths = get_montgomery_paths(path, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_montgomery_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          batch_size: int, resize_inputs: bool = True,
                          download: bool = False, **kwargs) -> DataLoader:
    """Get the Montgomery data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_montgomery_dataset(path, patch_shape, resize_inputs=resize_inputs,
                                download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
