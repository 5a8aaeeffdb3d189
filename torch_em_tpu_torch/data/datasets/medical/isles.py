"""ISLES 2022 dataset: ischemic stroke lesion segmentation in multimodal MRI
(DWI + ADC) (reference torch_em/data/datasets/medical/isles.py).

Located at https://doi.org/10.5281/zenodo.7960856;
challenge publication: https://doi.org/10.1038/s41597-022-01875-5
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/7960856/files/ISLES-2022.zip"
CHECKSUM = "f374895e383f725ddd280db41ef36ed975277c33de0e587a631ca7ea7ad45d6b"


def get_isles_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the ISLES 2022 data."""
    data_dir = os.path.join(path, "ISLES-2022")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "ISLES-2022.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_isles_paths(path: Union[os.PathLike, str], modality: str = "dwi",
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the ISLES volumes for a modality ('dwi' or 'adc')."""
    assert modality in ("dwi", "adc"), f"Invalid modality: {modality}"
    data_dir = get_isles_data(path, download)
    gt_paths = sorted(glob(os.path.join(data_dir, "derivatives", "sub-*", "**", "*.nii.gz"),
                           recursive=True))
    image_paths = sorted(glob(os.path.join(data_dir, "sub-*", "**", "dwi", f"*_{modality}.nii.gz"),
                              recursive=True))
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_isles_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                      modality: str = "dwi", download: bool = False, **kwargs):
    """Get the ISLES dataset for stroke lesion segmentation."""
    image_paths, gt_paths = get_isles_paths(path, modality, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_isles_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                     batch_size: int, modality: str = "dwi", download: bool = False,
                     **kwargs) -> DataLoader:
    """Get the ISLES data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_isles_dataset(path, patch_shape, modality=modality, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
