"""Neurite-OASIS dataset: brain tissue / anatomy segmentation in T1 MRI
(reference torch_em/data/datasets/medical/oasis.py).

From https://github.com/adalca/medical-datasets/blob/master/neurite-oasis.md;
publications: https://doi.org/10.59275/j.melba.2022-74f1,
https://doi.org/10.1162/jocn.2007.19.9.1498
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://surfer.nmr.mgh.harvard.edu/ftp/data/neurite/data/neurite-oasis.v1.0.tar"
CHECKSUM = "86dd117dda17f736ade8a4088d7e98e066e1181950fe8b406f1a35f7fb743e78"


def get_oasis_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the neurite-OASIS data."""
    data_path = os.path.join(path, "data")
    if os.path.exists(data_path):
        return data_path
    os.makedirs(path, exist_ok=True)
    tar_path = os.path.join(path, "neurite-oasis.v1.0.tar")
    util.download_source(tar_path, URL, download, CHECKSUM)
    util.unzip_tarfile(tar_path, data_path, remove=False)
    return data_path


def get_oasis_paths(path: Union[os.PathLike, str], split: str, source: str = "orig",
                    label_annotations: str = "4",
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the OASIS volumes; source 'orig' or 'norm' (skull
    stripped), labels '4' (tissues) or '35' (anatomy); 350/25/rest split."""
    get_oasis_data(path, download)
    patient_dirs = sorted(glob(os.path.join(path, "data", "OASIS_*")))
    raw_paths = [os.path.join(p, f"{source}.nii.gz") for p in patient_dirs]
    label_paths = [os.path.join(p, f"seg{label_annotations}.nii.gz") for p in patient_dirs]
    if split == "train":
        raw_paths, label_paths = raw_paths[:350], label_paths[:350]
    elif split == "val":
        raw_paths, label_paths = raw_paths[350:375], label_paths[350:375]
    elif split == "test":
        raw_paths, label_paths = raw_paths[375:], label_paths[375:]
    else:
        raise ValueError(f"'{split}' is not a valid split.")
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_oasis_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                      split: str, source: str = "orig", label_annotations: str = "4",
                      download: bool = False, **kwargs):
    """Get the OASIS dataset for brain segmentation."""
    raw_paths, label_paths = get_oasis_paths(path, split, source, label_annotations, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_oasis_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                     batch_size: int, split: str, source: str = "orig",
                     label_annotations: str = "4", download: bool = False,
                     **kwargs) -> DataLoader:
    """Get the OASIS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_oasis_dataset(path, patch_shape, split, source=source,
                           label_annotations=label_annotations, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
