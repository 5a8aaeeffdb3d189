"""VerSe dataset: vertebrae segmentation in CT (VerSe 2020 challenge)
(reference torch_em/data/datasets/medical/verse.py).

Publication: https://doi.org/10.1016/j.media.2021.102166
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = {
    "train": "https://files.de-1.osf.io/v1/resources/4skx2/providers/osfstorage/5ffa463786541a01e714d390/?zip=",
    "val": "https://files.de-1.osf.io/v1/resources/4skx2/providers/osfstorage/5ffa463686541a01eb15048c/?zip=",
    "test": "https://files.de-1.osf.io/v1/resources/4skx2/providers/osfstorage/5ffa4635ba010901f0891bd0/?zip=",
}
# OSF re-zips per download, so the checksums are not stable
CHECKSUM = {"train": None, "val": None, "test": None}


def get_verse_data(path: Union[os.PathLike, str], split: str,
                   download: bool = False) -> str:
    """Download the VerSe data for a split."""
    assert split in URL, f"Invalid split: {split}"
    data_dir = os.path.join(path, "data", split)
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, f"verse_{split}.zip")
    util.download_source(zip_path, URL[split], download, CHECKSUM[split])
    util.unzip(zip_path, data_dir)
    return data_dir


def get_verse_paths(path: Union[os.PathLike, str], split: str,
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the VerSe CT volumes and vertebra masks."""
    data_dir = get_verse_data(path, split, download)
    image_paths = util.natsorted(glob(os.path.join(data_dir, "rawdata", "*", "*_ct.nii.gz")))
    gt_paths = util.natsorted(glob(os.path.join(data_dir, "derivatives", "*", "*_msk.nii.gz")))
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_verse_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                      split: str, download: bool = False, **kwargs):
    """Get the VerSe dataset for vertebrae segmentation."""
    image_paths, gt_paths = get_verse_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_verse_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                     batch_size: int, split: str, download: bool = False,
                     **kwargs) -> DataLoader:
    """Get the VerSe data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_verse_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
