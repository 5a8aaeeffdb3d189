"""Omnipose training data: bacteria (fluorescence + phase-contrast) and worm
segmentation (reference torch_em/data/datasets/light_microscopy/omnipose.py).

Publication: https://doi.org/10.1038/s41592-022-01639-4
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://files.osf.io/v1/resources/xmury/providers/osfstorage/62f56c035775130690f25481/?zip="
# OSF dynamically compresses the folder, so the checksum changes per download.
CHECKSUM = None

DATA_CHOICES = ("bact_fluor", "bact_phase", "worm", "worm_high_res")


def get_omnipose_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the Omnipose training data."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "datasets.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, data_dir)
    return data_dir


def get_omnipose_paths(path: Union[os.PathLike, str], split: str,
                       data_choice: Optional[Union[str, List[str]]] = None,
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the Omnipose images and instance masks."""
    if split not in ("train", "test"):
        raise ValueError(f"'{split}' is not a valid split.")
    data_dir = get_omnipose_data(path, download)
    if data_choice is None:
        data_choice = list(DATA_CHOICES)
    elif isinstance(data_choice, str):
        data_choice = [data_choice]

    image_paths, label_paths = [], []
    for choice in data_choice:
        if choice not in DATA_CHOICES:
            raise ValueError(f"'{choice}' is not a valid Omnipose data choice.")
        if choice.startswith("bact"):
            base = os.path.join(data_dir, choice, f"{split}_sorted", "*")
            curr_labels = glob(os.path.join(base, "*_masks.tif"))
            curr_images = glob(os.path.join(base, "*.tif"))
        else:
            base = os.path.join(data_dir, choice, split)
            curr_labels = glob(os.path.join(base, "*_masks.*"))
            curr_images = glob(os.path.join(base, "*"))
        curr_images = [
            p for p in curr_images
            if not (p.endswith("_masks.tif") or p.endswith("_masks.png") or p.endswith("_flows.tif"))
        ]
        image_paths.extend(sorted(curr_images))
        label_paths.extend(sorted(curr_labels))
    assert len(image_paths) == len(label_paths)
    return image_paths, label_paths


def get_omnipose_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         split: str, data_choice: Optional[Union[str, List[str]]] = None,
                         boundaries: bool = False, binary: bool = False,
                         download: bool = False, **kwargs):
    """Get the Omnipose dataset for bacteria / worm segmentation."""
    image_paths, label_paths = get_omnipose_paths(path, split, data_choice, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries,
    )
    return default_segmentation_dataset(image_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_omnipose_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        batch_size: int, split: str,
                        data_choice: Optional[Union[str, List[str]]] = None,
                        boundaries: bool = False, binary: bool = False,
                        download: bool = False, **kwargs) -> DataLoader:
    """Get the Omnipose data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_omnipose_dataset(path, patch_shape, split, data_choice=data_choice,
                              boundaries=boundaries, binary=binary, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
