"""SPIDER dataset: lumbar spine segmentation (vertebrae, discs, spinal canal)
in MRI (reference torch_em/data/datasets/medical/spider.py).

Located at https://zenodo.org/records/10159290;
publication: https://www.nature.com/articles/s41597-024-03090-w
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = {
    "images": "https://zenodo.org/records/10159290/files/images.zip?download=1",
    "masks": "https://zenodo.org/records/10159290/files/masks.zip?download=1",
}
CHECKSUMS = {
    "images": "a54cba2905284ff6cc9999f1dd0e4d871c8487187db7cd4b068484eac2f50f17",
    "masks": "13a6e25a8c0d74f507e16ebb2edafc277ceeaf2598474f1fed24fdf59cb7f18f",
}


def get_spider_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the SPIDER data."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    for name in ("images", "masks"):
        zip_path = os.path.join(path, f"{name}.zip")
        util.download_source(zip_path, URL[name], download, CHECKSUMS[name])
        util.unzip(zip_path, data_dir)
    return data_dir


def get_spider_paths(path: Union[os.PathLike, str],
                     download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the SPIDER volumes (.mha)."""
    data_dir = get_spider_data(path, download)
    image_paths = util.natsorted(glob(os.path.join(data_dir, "images", "*.mha")))
    gt_paths = util.natsorted(glob(os.path.join(data_dir, "masks", "*.mha")))
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_spider_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                       download: bool = False, **kwargs):
    """Get the SPIDER dataset for lumbar spine segmentation."""
    image_paths, gt_paths = get_spider_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_spider_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                      batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the SPIDER data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_spider_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
