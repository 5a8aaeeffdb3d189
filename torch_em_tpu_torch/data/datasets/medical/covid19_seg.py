"""COVID-19 CT segmentation dataset: lung and infection segmentation in CT
(reference torch_em/data/datasets/medical/covid19_seg.py).

Located at https://doi.org/10.5281/zenodo.3757476;
publication: https://doi.org/10.1002/mp.14676
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = {
    "images": "https://zenodo.org/records/3757476/files/COVID-19-CT-Seg_20cases.zip",
    "lung_and_infection": "https://zenodo.org/records/3757476/files/Lung_and_Infection_Mask.zip",
    "lung": "https://zenodo.org/records/3757476/files/Lung_Mask.zip",
    "infection": "https://zenodo.org/records/3757476/files/Infection_Mask.zip",
}
CHECKSUM = {
    "images": "a5060480eff9315b069b086312dac4872777901fb80d268a5a83edd9f4e7b440",
    "lung_and_infection": "34f5a573cb8fb53cb15abe81868395d9addf436854826a6fd6e70c2b294f19c3",
    "lung": "f060b0d0299939a6d95ddefdbfa281de1a779c4d230a5adbd32414711d6d8187",
    "infection": "87901c73fdd2230260e61d2dbc57bf56026efc28264006b8ea2bf411453c1694",
}


def get_covid19_seg_data(path: Union[os.PathLike, str], task: str,
                         download: bool = False) -> Tuple[str, str]:
    """Download the COVID-19 CT data for a task
    ('lung' / 'infection' / 'lung_and_infection')."""
    assert task in ("lung", "infection", "lung_and_infection"), f"Invalid task: {task}"
    im_dir = os.path.join(path, "images", Path(os.path.basename(URL["images"])).stem)
    gt_dir = os.path.join(path, "gt", Path(os.path.basename(URL[task])).stem)
    if os.path.exists(im_dir) and os.path.exists(gt_dir):
        return im_dir, gt_dir
    os.makedirs(path, exist_ok=True)
    im_zip = os.path.join(path, os.path.basename(URL["images"]))
    util.download_source(im_zip, URL["images"], download, CHECKSUM["images"])
    util.unzip(im_zip, im_dir, remove=False)
    gt_zip = os.path.join(path, os.path.basename(URL[task]))
    util.download_source(gt_zip, URL[task], download, CHECKSUM[task])
    util.unzip(gt_zip, gt_dir)
    return im_dir, gt_dir


def get_covid19_seg_paths(path: Union[os.PathLike, str], task: str,
                          download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the COVID-19 CT volumes and masks."""
    image_dir, gt_dir = get_covid19_seg_data(path, task, download)
    image_paths = util.natsorted(glob(os.path.join(image_dir, "*.nii.gz")))
    gt_paths = util.natsorted(glob(os.path.join(gt_dir, "*.nii.gz")))
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_covid19_seg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                            task: str = "lung", download: bool = False, **kwargs):
    """Get the COVID-19 CT segmentation dataset."""
    image_paths, gt_paths = get_covid19_seg_paths(path, task, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_covid19_seg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                           batch_size: int, task: str = "lung", download: bool = False,
                           **kwargs) -> DataLoader:
    """Get the COVID-19 CT segmentation data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_covid19_seg_dataset(path, patch_shape, task=task, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
