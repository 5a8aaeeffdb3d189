"""OocyteSeg dataset: oocyte cortex segmentation in transmitted-light
microscopy across species
(reference torch_em/data/datasets/light_microscopy/oocyteseg.py).

Publication: https://doi.org/10.1242/jcs.260281
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = "https://zenodo.org/records/6502830/files/SegmentationCortex.tar.gz"
# the record only publishes an md5 digest; our checker uses sha256
CHECKSUM = None

_SUBDIRS = {
    "mouse": {"train": ["exp1", "exp2"], "test": ["exp1_test", "exp2_test"]},
    "human": {"train": ["clin1", "clin2"], "test": ["clin1_test", "clin2_test"]},
    "sea_urchin": {"train": ["train"], "test": ["test"]},
}


def _preprocess_data(data_dir, processed_dir, species, split):
    """Convert all inputs to single-channel uint8 and masks to 0/1."""
    Image = _pil_image()

    img_out_dir = os.path.join(processed_dir, "images")
    mask_out_dir = os.path.join(processed_dir, "masks")
    os.makedirs(img_out_dir, exist_ok=True)
    os.makedirs(mask_out_dir, exist_ok=True)
    for subdir in _SUBDIRS[species][split]:
        input_dir = os.path.join(data_dir, species, subdir, "input")
        mask_dir = os.path.join(data_dir, species, subdir, "mask")
        input_names = {os.path.splitext(f)[0] for f in os.listdir(input_dir) if f.endswith(".png")}
        mask_names = {os.path.splitext(f)[0] for f in os.listdir(mask_dir) if f.endswith(".png")}
        for name in sorted(input_names & mask_names):
            img_out = os.path.join(img_out_dir, f"{subdir}_{name}.tif")
            mask_out = os.path.join(mask_out_dir, f"{subdir}_{name}.tif")
            if os.path.exists(img_out) and os.path.exists(mask_out):
                continue
            img = np.asarray(load_image(os.path.join(input_dir, f"{name}.png")))
            if img.ndim == 3:
                img = np.mean(img[..., :3], axis=-1).astype("uint8")
            mask = np.asarray(load_image(os.path.join(mask_dir, f"{name}.png")))
            if mask.ndim == 3:
                mask = mask[..., 0]
            Image.fromarray(img).save(img_out)
            Image.fromarray((mask > 0).astype("uint8")).save(mask_out)


def get_oocyteseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the OocyteSeg data."""
    data_dir = os.path.join(path, "SegmentationCortex")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    tar_path = os.path.join(path, "SegmentationCortex.tar.gz")
    util.download_source(tar_path, URL, download, CHECKSUM)
    util.unzip_tarfile(tar_path, path)
    return data_dir


def get_oocyteseg_paths(path: Union[os.PathLike, str], split: str = "train",
                        species: str = "mouse",
                        download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the OocyteSeg images and masks (species: 'mouse' /
    'human' / 'sea_urchin')."""
    assert split in ("train", "test"), f"Invalid split: {split}"
    assert species in _SUBDIRS, f"Invalid species: {species}"
    data_dir = get_oocyteseg_data(path, download)
    processed_dir = os.path.join(data_dir, "preprocessed", species, split)
    _preprocess_data(data_dir, processed_dir, species, split)
    raw_paths = util.natsorted(glob(os.path.join(processed_dir, "images", "*.tif")))
    label_paths = util.natsorted(glob(os.path.join(processed_dir, "masks", "*.tif")))
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_oocyteseg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          split: str = "train", species: str = "mouse",
                          download: bool = False, **kwargs):
    """Get the OocyteSeg dataset for oocyte cortex segmentation."""
    raw_paths, label_paths = get_oocyteseg_paths(path, split, species, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_oocyteseg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         batch_size: int, split: str = "train", species: str = "mouse",
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the OocyteSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_oocyteseg_dataset(path, patch_shape, split=split, species=species,
                               download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
