"""mnDINO dataset: micronucleus and nucleus segmentation in fluorescence
microscopy (reference torch_em/data/datasets/light_microscopy/mndino.py).

Located at https://www.ebi.ac.uk/biostudies/studies/S-BIAD2809.
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URL = "https://www.ebi.ac.uk/biostudies/files/S-BIAD2809/annotated_mn_datasets.tar.gz"
CHECKSUM = None
_SPLIT_DIR = {"train": "train", "val": "validation", "test": "test"}


def _preprocess_data(path):
    h5py = _h5py()

    extracted_root = os.path.join(path, "annotated_mn_datasets")
    for split_key, split_dir in _SPLIT_DIR.items():
        h5_dir = os.path.join(path, "h5_data", split_key)
        os.makedirs(h5_dir, exist_ok=True)
        image_paths = util.natsorted(
            glob(os.path.join(extracted_root, split_dir, "images", "*.tif")))
        for img_path in image_paths:
            fname = os.path.splitext(os.path.basename(img_path))[0]
            h5_path = os.path.join(h5_dir, f"{fname}.h5")
            if os.path.exists(h5_path):
                continue
            nuclei_path = os.path.join(extracted_root, split_dir, "nuclei_masks", f"{fname}.tif")
            mn_path = os.path.join(extracted_root, split_dir, "mn_masks", f"{fname}.png")
            raw = np.asarray(load_image(img_path))
            with h5py.File(h5_path, "w") as f:
                f.create_dataset("raw", data=raw, compression="gzip")
                if os.path.exists(nuclei_path):
                    f.create_dataset("labels/nuclei",
                                     data=np.asarray(load_image(nuclei_path)).astype("int64"),
                                     compression="gzip")
                if os.path.exists(mn_path):
                    f.create_dataset("labels/micronuclei",
                                     data=np.asarray(load_image(mn_path)).astype("int64"),
                                     compression="gzip")


def get_mndino_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the mnDINO data."""
    extracted_root = os.path.join(path, "annotated_mn_datasets")
    if not os.path.exists(extracted_root):
        os.makedirs(path, exist_ok=True)
        tar_path = os.path.join(path, "annotated_mn_datasets.tar.gz")
        util.download_source(tar_path, URL, download, CHECKSUM)
        util.unzip_tarfile(tar_path, path, remove=False)
    return path


def get_mndino_paths(path: Union[os.PathLike, str], split: str,
                     download: bool = False) -> List[str]:
    """Get paths to the mnDINO volumes for a split."""
    if split not in _SPLIT_DIR:
        raise ValueError(f"'{split}' is not a valid split. Choose from {list(_SPLIT_DIR)}.")
    get_mndino_data(path, download)
    h5_dir = os.path.join(path, "h5_data", split)
    if not os.path.exists(h5_dir) or not glob(os.path.join(h5_dir, "*.h5")):
        _preprocess_data(str(path))
    h5_paths = util.natsorted(glob(os.path.join(h5_dir, "*.h5")))
    assert len(h5_paths) > 0, f"No data found for split '{split}' at '{h5_dir}'."
    return h5_paths


def get_mndino_dataset(path: Union[os.PathLike, str], patch_shape, split: str,
                       label_choice: str = "micronuclei", download: bool = False, **kwargs):
    """Get the mnDINO dataset (label_choice 'micronuclei' or 'nuclei')."""
    paths = get_mndino_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, f"labels/{label_choice}",
                                        patch_shape, ndim=2, **kwargs)


def get_mndino_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                      split: str, label_choice: str = "micronuclei",
                      download: bool = False, **kwargs) -> DataLoader:
    """Get the mnDINO data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_mndino_dataset(path, patch_shape, split, label_choice=label_choice,
                            download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
