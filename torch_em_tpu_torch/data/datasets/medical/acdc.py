"""ACDC dataset: multi-structure cardiac segmentation in cine-MRI
(reference torch_em/data/datasets/medical/acdc.py).

Challenge: https://www.creatis.insa-lyon.fr/Challenge/acdc/;
publication: https://doi.org/10.1109/TMI.2018.2837502
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = ("https://humanheart-project.creatis.insa-lyon.fr/database/api/v1/collection/"
       "637218c173e9f0047faa00fb/download")
CHECKSUM = "2787e08b0d3525cbac710fc3bdf69ee7c5fd7446472e49db8bc78548802f6b5e"


def get_acdc_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the ACDC data."""
    trg_dir = os.path.join(path, "ACDC")
    if os.path.exists(trg_dir):
        return trg_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "ACDC.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path, remove=False)
    return trg_dir


def get_acdc_paths(path: Union[os.PathLike, str], split: str,
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the ACDC ED/ES frame volumes and their annotations."""
    root_dir = get_acdc_data(path, download)
    if split == "train":
        input_dir = os.path.join(root_dir, "database", "training")
    elif split == "test":
        input_dir = os.path.join(root_dir, "database", "testing")
    else:
        raise ValueError(f"'{split}' is not a valid data split.")
    image_paths, gt_paths = [], []
    for per_patient_dir in util.natsorted(glob(os.path.join(input_dir, "patient*"))):
        for vol_path in glob(os.path.join(per_patient_dir, "*frame*.nii.gz")):
            if "gt" in os.path.basename(vol_path):
                gt_paths.append(vol_path)
            else:
                image_paths.append(vol_path)
    return util.natsorted(image_paths), util.natsorted(gt_paths)


def get_acdc_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                     split: str, download: bool = False, **kwargs):
    """Get the ACDC dataset for cardiac segmentation."""
    image_paths, gt_paths = get_acdc_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_acdc_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                    batch_size: int, split: str, download: bool = False,
                    **kwargs) -> DataLoader:
    """Get the ACDC data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_acdc_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
