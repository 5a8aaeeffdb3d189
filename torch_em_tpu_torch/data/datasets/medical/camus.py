"""CAMUS dataset: cardiac structure segmentation in 2D echocardiography
(reference torch_em/data/datasets/medical/camus.py).

Located at
https://humanheart-project.creatis.insa-lyon.fr/database/#collection/6373703d73e9f0047faa1bc8;
publication: https://doi.org/10.1109/TMI.2019.2900516
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = ("https://humanheart-project.creatis.insa-lyon.fr/database/api/v1/folder/"
       "63fde55f73e9f004868fb7ac/download")
# the server re-zips per request, so the checksum is not stable
CHECKSUM = None


def get_camus_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the CAMUS data."""
    data_dir = os.path.join(path, "database_nifti")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "CAMUS.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_camus_paths(path: Union[os.PathLike, str], chamber: Optional[int] = None,
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the CAMUS sequences and labels (chamber: 2 or 4,
    None for both)."""
    data_dir = get_camus_data(path, download)
    if chamber is None:
        chamber = "*"
    else:
        assert chamber in (2, 4), f"{chamber} is not a valid chamber choice."
        chamber = f"{chamber}CH"
    image_paths = sorted(glob(os.path.join(
        data_dir, "patient*", f"patient*_{chamber}_half_sequence.nii.gz")))
    gt_paths = sorted(glob(os.path.join(
        data_dir, "patient*", f"patient*_{chamber}_half_sequence_gt.nii.gz")))
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_camus_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                      chamber: Optional[int] = None, download: bool = False, **kwargs):
    """Get the CAMUS dataset for cardiac segmentation."""
    image_paths, gt_paths = get_camus_paths(path, chamber, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_camus_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                     batch_size: int, chamber: Optional[int] = None,
                     download: bool = False, **kwargs) -> DataLoader:
    """Get the CAMUS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_camus_dataset(path, patch_shape, chamber=chamber, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
