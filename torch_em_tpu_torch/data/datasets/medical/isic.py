"""ISIC 2018 dataset: skin lesion segmentation in dermoscopy images
(reference torch_em/data/datasets/medical/isic.py).

Located at https://challenge.isic-archive.com/data/#2018.
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = {
    "images": {
        "train": "https://isic-challenge-data.s3.amazonaws.com/2018/ISIC2018_Task1-2_Training_Input.zip",
        "val": "https://isic-challenge-data.s3.amazonaws.com/2018/ISIC2018_Task1-2_Validation_Input.zip",
        "test": "https://isic-challenge-data.s3.amazonaws.com/2018/ISIC2018_Task1-2_Test_Input.zip",
    },
    "gt": {
        "train": "https://isic-challenge-data.s3.amazonaws.com/2018/ISIC2018_Task1_Training_GroundTruth.zip",
        "val": "https://isic-challenge-data.s3.amazonaws.com/2018/ISIC2018_Task1_Validation_GroundTruth.zip",
        "test": "https://isic-challenge-data.s3.amazonaws.com/2018/ISIC2018_Task1_Test_GroundTruth.zip",
    },
}
CHECKSUM = {
    "images": {
        "train": "80f98572347a2d7a376227fa9eb2e4f7459d317cb619865b8b9910c81446675f",
        "val": "0ea920fcfe512d12a6e620b50b50233c059f67b10146e1479c82be58ff15a797",
        "test": "e59ae1f69f4ed16f09db2cb1d76c2a828487b63d28f6ab85997f5616869b127d",
    },
    "gt": {
        "train": "99f8b2bb3c4d6af483362010715f7e7d5d122d9f6c02cac0e0d15bef77c7604c",
        "val": "f6911e9c0a64e6d687dd3ca466ca927dd5e82145cb2163b7a1e5b37d7a716285",
        "test": "2e8f6edce454a5bdee52485e39f92bd6eddf357e81f39018d05512175238ef82",
    },
}


def get_isic_data(path: Union[os.PathLike, str], split: str,
                  download: bool = False) -> Tuple[str, str]:
    """Download the ISIC 2018 data for a split ('train' / 'val' / 'test')."""
    assert split in URL["images"], f"{split} is not a valid split."
    im_url, gt_url = URL["images"][split], URL["gt"][split]
    imdir = os.path.join(path, Path(os.path.split(im_url)[-1]).stem)
    gtdir = os.path.join(path, Path(os.path.split(gt_url)[-1]).stem)
    if os.path.exists(imdir) and os.path.exists(gtdir):
        return imdir, gtdir
    os.makedirs(path, exist_ok=True)
    for url, checksum in ((im_url, CHECKSUM["images"][split]), (gt_url, CHECKSUM["gt"][split])):
        zip_path = os.path.join(path, os.path.split(url)[-1])
        util.download_source(zip_path, url, download, checksum)
        util.unzip(zip_path, path, remove=False)
    return imdir, gtdir


def get_isic_paths(path: Union[os.PathLike, str], split: str,
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the ISIC images and lesion masks."""
    imdir, gtdir = get_isic_data(path, split, download)
    image_paths = sorted(glob(os.path.join(imdir, "*.jpg")))
    gt_paths = sorted(glob(os.path.join(gtdir, "*.png")))
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_isic_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     split: str, resize_inputs: bool = True,
                     download: bool = False, **kwargs):
    """Get the ISIC 2018 dataset for skin lesion segmentation."""
    image_paths, gt_paths = get_isic_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_isic_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                    batch_size: int, split: str, resize_inputs: bool = True,
                    download: bool = False, **kwargs) -> DataLoader:
    """Get the ISIC 2018 data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_isic_dataset(path, patch_shape, split, resize_inputs=resize_inputs,
                          download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
