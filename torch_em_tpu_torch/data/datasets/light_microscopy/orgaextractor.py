"""OrgaExtractor dataset: colon organoid segmentation in brightfield images
(reference torch_em/data/datasets/light_microscopy/orgaextractor.py).

Hosted on google drive via https://github.com/tpark16/orgaextractor.
Semantic masks are converted to instances via connected components.
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....ops.host import connected_components
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URLS = {
    "train": "https://drive.google.com/uc?export=download&id=1u987UNcZxWkEwe5gjLoR3-M0lBNicXQ1",
    "val": "https://drive.google.com/uc?export=download&id=1UsBrHOYY0Orkb4vsRP8SaDj-CeYfGpFG",
    "test": "https://drive.google.com/uc?export=download&id=1IXqu1MqMZzfw1_GzZauUhg1As_abbk6N",
}
CHECKSUMS = {
    "train": "279bcfbcbd2fba23bbdea362b23eedacc53193034f4d23eb94ef570896da4f60",
    "val": "3d2288a7be39a692af2eb86bea520e7db332191cd372a8c970679b5bede61b7e",
    "test": "8e110ad8543031ed61c61bee5e8b41492b746d0dc8c503b6f8d4869b29a308e6",
}


def _preprocess_data(data_dir):
    Image = _pil_image()
    for gt_path in util.natsorted(glob(os.path.join(data_dir, "*.tif"))):
        gt = np.asarray(load_image(gt_path))
        if gt.ndim == 3:  # all three channels are identical
            gt = gt[..., 0]
        gt = connected_components(gt > 0).astype("int32")
        Image.fromarray(gt, mode="I").save(gt_path)


def get_orgaextractor_data(path: Union[os.PathLike, str], split: str,
                           download: bool = False) -> str:
    """Download the OrgaExtractor data for a split."""
    assert split in URLS, f"'{split}' is not a valid split."
    data_dir = os.path.join(path, split)
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(data_dir, exist_ok=True)
    zip_path = os.path.join(data_dir, f"{split}.zip")
    util.download_source_gdrive(zip_path, URLS[split], download, CHECKSUMS[split],
                                download_type="zip")
    util.unzip(zip_path, data_dir)
    _preprocess_data(data_dir)
    return data_dir


def get_orgaextractor_paths(path: Union[os.PathLike, str], split: str,
                            download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the OrgaExtractor images and instance masks."""
    data_dir = get_orgaextractor_data(path, split, download)
    image_paths = util.natsorted(glob(os.path.join(data_dir, "*.jpg")))
    gt_paths = util.natsorted(glob(os.path.join(data_dir, "*.tif")))
    assert len(image_paths) == len(gt_paths) and len(image_paths) > 0
    return image_paths, gt_paths


def get_orgaextractor_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                              split: str, download: bool = False, **kwargs):
    """Get the OrgaExtractor dataset for organoid segmentation."""
    image_paths, gt_paths = get_orgaextractor_paths(path, split, download)
    return default_segmentation_dataset(
        image_paths, None, gt_paths, None, patch_shape,
        is_seg_dataset=False, ndim=2, **kwargs,
    )


def get_orgaextractor_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                             batch_size: int, split: str, download: bool = False,
                             **kwargs) -> DataLoader:
    """Get the OrgaExtractor data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_orgaextractor_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
