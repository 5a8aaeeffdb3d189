"""Arvidsson dataset: nucleus segmentation in high-content fluorescence
screening (reference torch_em/data/datasets/light_microscopy/arvidsson.py).

Publication: https://doi.org/10.1016/j.dib.2022.108769
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URLS = {
    "train": "https://zenodo.org/records/6657260/files/training_nuclei.zip",
    "val": "https://zenodo.org/records/6657260/files/development_nuclei.zip",
    "test": "https://zenodo.org/records/6657260/files/test_nuclei.zip",
}
CHECKSUMS = {
    "train": "df075941f4e561f9ef82d4c48d22cf97e3627a0b63fa136675197614813fff90",
    "val": "722530a93fd5b67f61d52964651c715be6227c1c0508c4c95ef2b04b52fc1dd1",
    "test": "377dc719c4eaf9bfa30273f7e3a4042d98dbbfc4a1c4af2a467879237bff592f",
}
_FOLDERS = {"train": "training_nuclei", "val": "development_nuclei", "test": "test_nuclei"}


def get_arvidsson_data(path: Union[os.PathLike, str], split: str,
                       download: bool = False) -> str:
    """Download the Arvidsson data for a split ('train', 'val' or 'test')."""
    if split not in URLS:
        raise ValueError(f"'{split}' is not a valid split.")
    data_dir = os.path.join(path, _FOLDERS[split])
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, f"{_FOLDERS[split]}.zip")
    util.download_source(zip_path, URLS[split], download, CHECKSUMS[split])
    util.unzip(zip_path, path)
    return data_dir


def _rgb_to_instances(labels):
    """Convert RGB-coded instance labels to a single-channel instance map
    (each unique color = one instance; black = background)."""
    background_mask = np.all(labels == 0, axis=-1)
    instances = np.zeros(labels.shape[:2], dtype="uint32")
    fg = labels[~background_mask].reshape(-1, 3)
    if len(fg):
        _, indices = np.unique(fg, axis=0, return_inverse=True)
        instances[~background_mask] = indices.astype("uint32") + 1
    return instances


def get_arvidsson_paths(path: Union[os.PathLike, str], split: str,
                        download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the Arvidsson images and (preprocessed) instance labels."""
    Image = _pil_image()

    data_dir = get_arvidsson_data(path, split, download)
    raw_paths = sorted(glob(os.path.join(data_dir, "images", "*.png")))
    label_paths = sorted(glob(os.path.join(data_dir, "annotations", "*_preprocessed.tif")))
    if len(raw_paths) == len(label_paths):
        return raw_paths, label_paths

    label_paths = []
    for lpath in sorted(glob(os.path.join(data_dir, "annotations", "*.png"))):
        instance_path = lpath.replace(".png", "_preprocessed.tif")
        label_paths.append(instance_path)
        if os.path.exists(instance_path):
            continue
        labels = np.asarray(load_image(lpath))
        instances = _rgb_to_instances(labels)
        Image.fromarray(instances.astype("int32"), mode="I").save(instance_path)
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_arvidsson_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          split: str, offsets=None, boundaries: bool = False,
                          binary: bool = False, download: bool = False, **kwargs):
    """Get the Arvidsson dataset for nucleus segmentation."""
    image_paths, label_paths = get_arvidsson_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(image_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_arvidsson_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         batch_size: int, split: str, offsets=None,
                         boundaries: bool = False, binary: bool = False,
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the Arvidsson data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_arvidsson_dataset(path, patch_shape, split, offsets=offsets,
                               boundaries=boundaries, binary=binary, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
