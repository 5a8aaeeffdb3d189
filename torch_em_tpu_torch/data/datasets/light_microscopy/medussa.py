"""MeDuSSA dataset: bacterial membrane instance segmentation in FM 4-64
stained fluorescence microscopy (reference
torch_em/data/datasets/light_microscopy/medussa.py).

143 training + 16 benchmarking images of membrane-stained bacteria (primarily
Bacillus subtilis PY79) with instance masks. Hosted on BioStudies
(S-BIAD2350); publication https://doi.org/10.1101/2025.10.26.684635.
"""

import json
import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

BASE_URL = "https://www.ebi.ac.uk/biostudies/files/S-BIAD2350"

SPLIT_FILE_LISTS = {
    "train": {
        "images": "submission_segmentation_training_images_raw.json",
        "masks": "submission_segmentation_training_masks.json",
    },
    "test": {
        "images": "submission_segmentation_benchmarking_images_raw.json",
        "masks": "submission_segmentation_benchmarking_masks.json",
    },
}


def _download_file_lists(path, split):
    """Download + parse the BioStudies JSON file lists (relative file paths)."""
    file_list_dir = os.path.join(str(path), "file_lists")
    os.makedirs(file_list_dir, exist_ok=True)

    result = {}
    for key in ("images", "masks"):
        json_fname = SPLIT_FILE_LISTS[split][key]
        json_path = os.path.join(file_list_dir, json_fname)
        if not os.path.exists(json_path):
            util.download_source(path=json_path, url=f"{BASE_URL}/{json_fname}",
                                 download=True, checksum=None)
        with open(json_path) as f:
            data = json.load(f)
        result[key] = sorted(entry["path"] for entry in data)
    return result["images"], result["masks"]


def _create_h5_data(path, split, image_paths_rel, mask_paths_rel):
    """Write (raw, int64 instance labels) h5 files; z-stacks are max-projected."""
    h5py = _h5py()

    h5_dir = os.path.join(str(path), "h5_data", split)
    os.makedirs(h5_dir, exist_ok=True)
    assert len(image_paths_rel) == len(mask_paths_rel), \
        f"Mismatch: {len(image_paths_rel)} images vs {len(mask_paths_rel)} masks for split '{split}'"

    for img_rel, mask_rel in zip(image_paths_rel, mask_paths_rel):
        fname = os.path.splitext(os.path.basename(img_rel))[0]
        h5_path = os.path.join(h5_dir, f"{fname}.h5")
        if os.path.exists(h5_path):
            continue
        raw = np.asarray(load_image(os.path.join(str(path), img_rel)))
        labels = np.asarray(load_image(os.path.join(str(path), mask_rel)))
        if raw.ndim > 2:
            raw = raw.max(axis=0)
        if labels.ndim > 2:
            labels = labels.max(axis=0)
        with h5py.File(h5_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=labels.astype("int64"), compression="gzip")
    return h5_dir


def get_medussa_data(path: Union[os.PathLike, str], split: str = "train",
                     download: bool = False) -> str:
    """Download the MeDuSSA images + masks for a split ('train'/'test')."""
    assert split in ("train", "test"), f"'{split}' is not a valid split."
    image_paths_rel, mask_paths_rel = _download_file_lists(path, split)
    for rel_path in image_paths_rel + mask_paths_rel:
        local = os.path.join(str(path), rel_path)
        if os.path.exists(local):
            continue
        os.makedirs(os.path.dirname(local), exist_ok=True)
        util.download_source(path=local, url=f"{BASE_URL}/{rel_path}",
                             download=download, checksum=None)
    return str(path)


def get_medussa_paths(path: Union[os.PathLike, str], split: str = "train",
                      download: bool = False) -> List[str]:
    """Paths to the processed MeDuSSA h5 files."""
    get_medussa_data(path, split, download)
    h5_dir = os.path.join(str(path), "h5_data", split)
    if not os.path.exists(h5_dir) or len(glob(os.path.join(h5_dir, "*.h5"))) == 0:
        image_paths_rel, mask_paths_rel = _download_file_lists(path, split)
        _create_h5_data(path, split, image_paths_rel, mask_paths_rel)
    h5_paths = util.natsorted(glob(os.path.join(h5_dir, "*.h5")))
    assert len(h5_paths) > 0, f"No data found for split '{split}'"
    return h5_paths


def get_medussa_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        split: str = "train", download: bool = False, **kwargs):
    """Dataset for bacterial membrane instance segmentation."""
    h5_paths = get_medussa_paths(path, split, download)
    return default_segmentation_dataset(
        raw_paths=h5_paths, raw_key="raw",
        label_paths=h5_paths, label_key="labels",
        patch_shape=patch_shape, ndim=2, **kwargs,
    )


def get_medussa_loader(path: Union[os.PathLike, str], batch_size: int,
                       patch_shape: Tuple[int, int], split: str = "train",
                       download: bool = False, **kwargs) -> DataLoader:
    """DataLoader for bacterial membrane instance segmentation."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_medussa_dataset(path, patch_shape, split=split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size, **loader_kwargs)
