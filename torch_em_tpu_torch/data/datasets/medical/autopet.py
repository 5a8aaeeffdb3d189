"""AutoPET-II dataset: whole-body tumor lesion segmentation in FDG-PET/CT
(reference torch_em/data/datasets/medical/autopet.py).

Challenge: https://autopet-ii.grand-challenge.org/.
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

AUTOPET_DATA = "http://193.196.20.155/data/autoPET/data/nifti.zip"
CHECKSUM = "0ac2186ea6d936ff41ce605c6a9588aeb20f031085589897dbab22fc82a12972"


def get_autopet_data(path: Union[os.PathLike, str], download: bool = False):
    """Download the AutoPET-II data (large, >100GB unpacked)."""
    target_dir = os.path.join(path, "AutoPET-II")
    if os.path.exists(target_dir):
        return
    os.makedirs(target_dir)
    zip_path = os.path.join(path, "autopet.zip")
    util.download_source(zip_path, AUTOPET_DATA, download, CHECKSUM)
    util.unzip(zip_path, target_dir, remove=False)


def get_autopet_paths(path: Union[os.PathLike, str], modality: Optional[str] = None,
                      download: bool = False) -> Tuple[List, List[str]]:
    """Get paths to the AutoPET volumes (modality 'CT', 'PET', or None for
    both stacked as channels)."""
    get_autopet_data(path, download)
    root_dir = os.path.join(path, "AutoPET-II", "FDG-PET-CT-Lesions", "*", "*")
    ct_paths = sorted(glob(os.path.join(root_dir, "CTres.nii.gz")))
    pet_paths = sorted(glob(os.path.join(root_dir, "SUV.nii.gz")))
    label_paths = sorted(glob(os.path.join(root_dir, "SEG.nii.gz")))
    if modality is None:
        raw_paths = [list(pair) for pair in zip(ct_paths, pet_paths)]
    elif modality == "CT":
        raw_paths = ct_paths
    elif modality == "PET":
        raw_paths = pet_paths
    else:
        raise ValueError("Choose from the available modalities: 'CT' / 'PET'.")
    return raw_paths, label_paths


def get_autopet_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                        modality: Optional[str] = None, download: bool = False, **kwargs):
    """Get the AutoPET-II dataset for lesion segmentation."""
    raw_paths, label_paths = get_autopet_paths(path, modality, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        with_channels=modality is None, **kwargs)


def get_autopet_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                       batch_size: int, modality: Optional[str] = None,
                       download: bool = False, **kwargs) -> DataLoader:
    """Get the AutoPET-II data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_autopet_dataset(path, patch_shape, modality=modality, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
