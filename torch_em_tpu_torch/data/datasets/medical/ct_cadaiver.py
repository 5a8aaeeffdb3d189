"""CadAIver dataset: vertebrae segmentation in cadaver CT
(reference torch_em/data/datasets/medical/ct_cadaiver.py).

Located at https://zenodo.org/records/10053317.
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/10053317/files/CadAIver%20study.zip"
CHECKSUM = None  # the reference publishes no checksum for this archive


def get_ct_cadaiver_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the CadAIver data."""
    data_dir = os.path.join(path, "CadAIver study")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "CadAIver study.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_ct_cadaiver_paths(path: Union[os.PathLike, str],
                          download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the CadAIver volumes and vertebra labels."""
    data_dir = get_ct_cadaiver_data(path, download)
    raw_paths = util.natsorted(glob(os.path.join(data_dir, "Images", "*.nii.gz")))
    label_paths = [p.replace("Images", "Segmentations").replace(".nii.gz", "_seg.nii.gz")
                   for p in raw_paths]
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_ct_cadaiver_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                            download: bool = False, **kwargs):
    """Get the CadAIver dataset for vertebrae segmentation."""
    raw_paths, label_paths = get_ct_cadaiver_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_ct_cadaiver_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                           batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the CadAIver data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_ct_cadaiver_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
