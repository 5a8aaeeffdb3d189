"""OIMHS dataset: macular hole and retinal structure segmentation in OCT
(reference torch_em/data/datasets/medical/oimhs.py).

Publication: https://doi.org/10.1038/s41597-023-02675-1
"""

import json
import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = "https://springernature.figshare.com/ndownloader/files/42522673"
CHECKSUM = "d93ba18964614eb9b0ba4b8dfee269efbb94ff27142e4b5ecf7cc86f3a1f9d80"

LABEL_MAPS = {
    (255, 255, 0): 1,  # choroid
    (0, 255, 0): 2,    # retina
    (0, 0, 255): 3,    # intraretinal cysts
    (255, 0, 0): 4,    # macular hole
}


def get_oimhs_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the OIMHS data."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "oimhs_dataset.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, data_dir)
    return data_dir


def _create_splits(data_dir, split_file, test_fraction=0.2):
    eye_dirs = [Path(e).stem for e in util.natsorted(glob(os.path.join(data_dir, "Images", "*")))]
    main_split, test_split = util._train_test_split(eye_dirs, test_size=test_fraction)
    train_split, val_split = util._train_test_split(main_split, test_size=0.1)
    with open(split_file, "w") as f:
        json.dump({"train": train_split, "val": val_split, "test": test_split}, f)


def get_oimhs_paths(path: Union[os.PathLike, str], split: str,
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the OIMHS scans and (color->id converted) labels."""
    Image = _pil_image()

    data_dir = get_oimhs_data(path, download)
    image_dir = os.path.join(data_dir, "preprocessed", "images")
    gt_dir = os.path.join(data_dir, "preprocessed", "gt")
    os.makedirs(image_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    split_file = os.path.join(path, "split_file.json")
    if not os.path.exists(split_file):
        _create_splits(data_dir, split_file)
    with open(split_file) as f:
        eye_ids = json.load(f)[split]

    image_paths, gt_paths = [], []
    for eye_id in eye_ids:
        eye_dir = os.path.join(data_dir, "Images", eye_id)
        for per_scan_path in util.natsorted(glob(os.path.join(eye_dir, "*.png"))):
            scan_id = Path(per_scan_path).stem
            image_path = os.path.join(image_dir, f"{eye_id}_{scan_id}.tif")
            gt_path = os.path.join(gt_dir, f"{eye_id}_{scan_id}.tif")
            image_paths.append(image_path)
            gt_paths.append(gt_path)
            if os.path.exists(image_path) and os.path.exists(gt_path):
                continue
            scan = np.asarray(load_image(per_scan_path))
            image, gt = scan[:, :512, :], scan[:, 512:, :]
            instances = np.zeros(image.shape[:2], dtype="uint8")
            for lmap, idx in LABEL_MAPS.items():
                instances[(gt == lmap).all(axis=2)] = idx
            Image.fromarray(image).save(image_path)
            Image.fromarray(instances).save(gt_path)
    return image_paths, gt_paths


def get_oimhs_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                      split: str, resize_inputs: bool = False,
                      download: bool = False, **kwargs):
    """Get the OIMHS dataset for OCT segmentation."""
    image_paths, gt_paths = get_oimhs_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_oimhs_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     batch_size: int, split: str, resize_inputs: bool = False,
                     download: bool = False, **kwargs) -> DataLoader:
    """Get the OIMHS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_oimhs_dataset(path, patch_shape, split, resize_inputs=resize_inputs,
                           download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
