"""FeTA24 dataset: fetal brain tissue segmentation in T2w MRI
(reference torch_em/data/datasets/medical/feta24.py).

The data must be downloaded manually via the FeTA challenge's synapse
project (https://www.synapse.org/#!Synapse:syn25649159/wiki/610007);
publication: https://doi.org/10.1038/s41597-021-00946-3
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util


def get_feta24_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Unpack the manually downloaded FeTA24 zip."""
    if download:
        raise NotImplementedError(
            "FeTA24 must be downloaded manually via synapse; see the module docstring."
        )
    data_dir = os.path.join(path, "feta_2.3")
    if os.path.exists(data_dir):
        return data_dir
    zip_path = os.path.join(path, "feta_2.3.zip")
    if not os.path.exists(zip_path):
        raise FileNotFoundError(
            f"The downloaded zip file was not found; please place it at '{path}'.")
    util.unzip(zip_path, path)
    return data_dir


def get_feta24_paths(path: Union[os.PathLike, str],
                     download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the FeTA24 T2w volumes and tissue labels."""
    data_dir = get_feta24_data(path, download)
    base_dir = os.path.join(data_dir, "sub-*", "anat")
    image_paths = util.natsorted(glob(os.path.join(base_dir, "sub-*_rec-*_T2w.nii.gz")))
    gt_paths = util.natsorted(glob(os.path.join(base_dir, "sub-*_rec-*_dseg.nii.gz")))
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_feta24_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                       download: bool = False, **kwargs):
    """Get the FeTA24 dataset for fetal brain tissue segmentation."""
    image_paths, gt_paths = get_feta24_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_feta24_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                      batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the FeTA24 data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_feta24_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
