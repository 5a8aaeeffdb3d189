"""OrganoID dataset: pancreatic (PDAC) organoid segmentation in brightfield
microscopy (reference torch_em/data/datasets/light_microscopy/organoid.py).

From the publication https://doi.org/10.1371/journal.pcbi.1010584, hosted
on OSF. Three sources: 'original' (PDAC), 'mouse' (mouse organoids), and
'gemcitabine' (two-channel BF + propidium-iodide screens).
"""

import os
import shutil
from glob import glob
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from ... import DataLoader
from ....ops.host import connected_components
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URL = "https://osf.io/download/69nr8/"


def _store_files_as_h5(data_dir, image_dir, label_dir):
    h5py = _h5py()

    if os.path.exists(data_dir):
        return
    os.makedirs(data_dir, exist_ok=True)
    image_paths = util.natsorted(glob(os.path.join(image_dir, "*")))
    gt_paths = util.natsorted(glob(os.path.join(label_dir, "*")))
    assert image_paths and len(image_paths) == len(gt_paths)
    for image_path, gt_path in zip(image_paths, gt_paths):
        image = np.asarray(load_image(image_path))
        gt = np.asarray(load_image(gt_path))
        if gt.ndim == 3:
            gt = gt[..., 0]
        gt = connected_components(gt > 0).astype("uint16")
        if image.ndim == 3 and image.shape[-1] == 4:
            image = image[..., :-1]
        elif image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        assert image.ndim == 3 and image.shape[-1] == 3, image.shape
        image = image.transpose(2, 0, 1)
        with h5py.File(os.path.join(data_dir, f"{Path(image_path).stem}.h5"), "w") as f:
            f.create_dataset("raw", data=image, compression="gzip")
            f.create_dataset("labels", data=gt, compression="gzip")


def _preprocess_per_species(data_dir, stype, dirname):
    for split, src_split, img_sub in (
            ("train", "training", "pre_augmented"), ("val", "validation", None),
            ("test", "testing", None)):
        base = os.path.join(data_dir, stype, src_split)
        if img_sub:
            base = os.path.join(base, img_sub)
        _store_files_as_h5(
            os.path.join(data_dir, dirname, split),
            os.path.join(base, "images"), os.path.join(base, "segmentations"),
        )


def _preprocess_data(data_dir):
    h5py = _h5py()

    _preprocess_per_species(data_dir, "OriginalData", "original")
    _preprocess_per_species(data_dir, "MouseOrganoids", "mouse")
    gdir = os.path.join(data_dir, "gemcitabine")
    if not os.path.exists(gdir):
        os.makedirs(gdir, exist_ok=True)
        bf_paths = util.natsorted(glob(os.path.join(data_dir, "GemcitabineScreen", "BF", "*.tif")))
        pi_paths = util.natsorted(glob(os.path.join(data_dir, "GemcitabineScreen", "PI", "*.tif")))
        label_paths = util.natsorted(glob(
            os.path.join(data_dir, "GemcitabineScreen", "OrganoIDProcessed", "*_labeled.tif")))
        assert label_paths and len(label_paths) == len(bf_paths) == len(pi_paths)
        for bf_path, pi_path, label_path in zip(bf_paths, pi_paths, label_paths):
            bf_image = np.asarray(load_image(bf_path))
            pi_image = np.asarray(load_image(pi_path))
            gt = np.asarray(load_image(label_path))
            assert bf_image.shape == pi_image.shape == gt.shape
            with h5py.File(os.path.join(gdir, f"{Path(bf_path).stem}.h5"), "w") as f:
                f.create_dataset("raw/bf", data=bf_image, compression="gzip")
                f.create_dataset("raw/pi", data=pi_image, compression="gzip")
                f.create_dataset("labels", data=gt, compression="gzip")
    for folder in ("OriginalData", "MouseOrganoids", "GemcitabineScreen"):
        if os.path.exists(os.path.join(data_dir, folder)):
            shutil.rmtree(os.path.join(data_dir, folder))


def get_organoid_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the OrganoID data."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "data.zip")
    util.download_source(zip_path, URL, download)
    util.unzip(zip_path, data_dir)
    _preprocess_data(data_dir)
    return data_dir


def get_organoid_paths(path: Union[os.PathLike, str], split: Optional[str] = None,
                       source: str = "original", download: bool = False) -> List[str]:
    """Get paths to the OrganoID h5 volumes."""
    if source == "gemcitabine":
        assert split is None, "The 'gemcitabine' data has no data splits."
        split = ""
    else:
        assert split is not None, f"The '{source}' data expects a data split."
    data_dir = get_organoid_data(path, download)
    input_paths = util.natsorted(glob(os.path.join(data_dir, source, split, "*.h5")))
    assert len(input_paths) > 0
    return input_paths


def get_organoid_dataset(path: Union[os.PathLike, str], patch_shape,
                         split: Optional[str] = None, source: str = "original",
                         source_channels: Optional[Union[str, List[str]]] = None,
                         download: bool = False, **kwargs):
    """Get the OrganoID dataset for organoid segmentation."""
    input_paths = get_organoid_paths(path, split, source, download)
    if source == "gemcitabine":
        assert source_channels is not None, \
            "You must choose 'source_channels' for the 'gemcitabine' data."
        ndim = 3
        if isinstance(source_channels, str):
            raw_key, with_channels = f"raw/{source_channels}", False
        else:
            raw_key = [f"raw/{c}" for c in source_channels]
            with_channels = True
    else:
        ndim, raw_key, with_channels = 2, "raw", True
    return default_segmentation_dataset(
        input_paths, raw_key, input_paths, "labels", patch_shape,
        is_seg_dataset=True, ndim=ndim, with_channels=with_channels, **kwargs,
    )


def get_organoid_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                        split: Optional[str] = None, source: str = "original",
                        source_channels: Optional[Union[str, List[str]]] = None,
                        download: bool = False, **kwargs) -> DataLoader:
    """Get the OrganoID data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_organoid_dataset(path, patch_shape, split=split, source=source,
                              source_channels=source_channels, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
