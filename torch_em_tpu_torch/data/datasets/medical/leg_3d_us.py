"""LEG 3D US dataset: leg muscle segmentation in 3D ultrasound
(reference torch_em/data/datasets/medical/leg_3d_us.py).

Located at https://www.cs.cit.tum.de/camp/publications/leg-3d-us-dataset/;
publication: https://doi.org/10.1007/s11548-024-03170-7
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.medical_io import load_mha, save_mha
from .. import util

URLS = {
    "train": "https://www.campar.in.tum.de/public_datasets/2024_IPCAI_Vanessa/leg_train_data.zip",
    "val": "https://www.campar.in.tum.de/public_datasets/2024_IPCAI_Vanessa/leg_validation_data.zip",
    "test": "https://www.campar.in.tum.de/public_datasets/2024_IPCAI_Vanessa/leg_test_data.zip",
}
CHECKSUMS = {
    "train": "747e9ada7135979218d93022ac46d40a3a85119e2ea7aebcda4b13f7dfda70d6",
    "val": "c204fa0759dd279de722a423401da60657bc0d1ab5f57d135cd0ad55c32af70f",
    "test": "42ad341e8133f827d35f9cb3afde3ffbe5ae97dc2af448b6f9af6d4ea6ac99f0",
}


def get_leg_3d_us_data(path: Union[os.PathLike, str], split: str,
                       download: bool = False):
    """Download the LEG 3D US data for a split."""
    if split not in URLS:
        raise ValueError(f"'{split}' is not a valid split.")
    data_dir = os.path.join(path, split)
    if os.path.exists(data_dir):
        return
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, f"leg_{split}_data.zip")
    util.download_source(zip_path, URLS[split], download, CHECKSUMS[split])
    util.unzip(zip_path, path)


def _preprocess_labels(label_paths):
    """Map the muscle label ids (100/150/200) to consecutive ids 1/2/3."""
    neu_label_paths = []
    for lpath in label_paths:
        neu_label_path = lpath.replace(".mha", "_preprocessed.mha")
        neu_label_paths.append(neu_label_path)
        if os.path.exists(neu_label_path):
            continue
        larray = np.array(load_mha(lpath))
        valid_labels = [100, 150, 200]
        larray[~np.isin(larray, valid_labels)] = 0
        for i, lid in enumerate(valid_labels, start=1):
            larray[larray == lid] = i
        save_mha(neu_label_path, larray)
    return neu_label_paths


def get_leg_3d_us_paths(path: Union[os.PathLike, str], split: str,
                        download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the LEG 3D US volumes and preprocessed labels."""
    get_leg_3d_us_data(path, split, download)
    raw_paths = util.natsorted(glob(os.path.join(path, split, "*", "x*.mha")))
    # the label file's name is the volume's with each "x" made "masksX"; the folders keep theirs
    label_paths = [os.path.join(os.path.dirname(p), os.path.basename(p).replace("x", "masksX"))
                   for p in raw_paths]
    label_paths = _preprocess_labels(label_paths)
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_leg_3d_us_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                          split: str, download: bool = False, **kwargs):
    """Get the LEG 3D US dataset for muscle segmentation."""
    raw_paths, label_paths = get_leg_3d_us_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_leg_3d_us_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                         batch_size: int, split: str, download: bool = False,
                         **kwargs) -> DataLoader:
    """Get the LEG 3D US data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_leg_3d_us_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
