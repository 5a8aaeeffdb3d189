"""SynthMT dataset: synthetic microtubule instance segmentation in
microscopy images (reference
torch_em/data/datasets/light_microscopy/synthmt.py).

Hosted at https://huggingface.co/datasets/HTW-KI-Werkstatt/SynthMT
as sharded parquet files.
"""

import os
from glob import glob
from io import BytesIO
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image
from .. import util

URL = "https://huggingface.co/datasets/HTW-KI-Werkstatt/SynthMT/resolve/main/data/{FILENAME}"
NUM_PARQUET_FILES = 8


def _download_parquets(path, download):
    parquet_dir = os.path.join(path, "parquets")
    os.makedirs(parquet_dir, exist_ok=True)
    for i in range(NUM_PARQUET_FILES):
        fname = f"train-{i:05d}-of-{NUM_PARQUET_FILES:05d}.parquet"
        fpath = os.path.join(parquet_dir, fname)
        if not os.path.exists(fpath):
            util.download_source(fpath, URL.format(FILENAME=fname), download)
    return parquet_dir


def _create_images_from_parquets(path):
    Image = _pil_image()
    import pandas as pd

    image_dir = os.path.join(path, "images")
    label_dir = os.path.join(path, "labels")
    os.makedirs(image_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)
    for pfile in sorted(glob(os.path.join(path, "parquets", "*.parquet"))):
        df = pd.read_parquet(pfile)
        for _, row in df.iterrows():
            sample_id = row["id"]
            img_path = os.path.join(image_dir, f"{sample_id}.tif")
            lbl_path = os.path.join(label_dir, f"{sample_id}.tif")
            if os.path.exists(img_path) and os.path.exists(lbl_path):
                continue
            img_arr = np.array(Image.open(BytesIO(row["image"]["bytes"])).convert("RGB"))
            instances = np.zeros(img_arr.shape[:2], dtype="int32")
            for i, mask_entry in enumerate(row["mask"], start=1):
                mask = np.array(Image.open(BytesIO(mask_entry["bytes"])).convert("L"))
                instances[mask > 0] = i
            Image.fromarray(img_arr).save(img_path)
            Image.fromarray(instances, mode="I").save(lbl_path)


def get_synthmt_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the SynthMT parquets and extract image/label tifs."""
    os.makedirs(path, exist_ok=True)
    _download_parquets(path, download)
    image_dir = os.path.join(path, "images")
    if not os.path.exists(image_dir) or len(glob(os.path.join(image_dir, "*.tif"))) == 0:
        _create_images_from_parquets(path)
    return path


def get_synthmt_paths(path: Union[os.PathLike, str],
                      download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the SynthMT images and instance labels."""
    get_synthmt_data(path, download)
    image_paths = util.natsorted(glob(os.path.join(path, "images", "*.tif")))
    label_paths = util.natsorted(glob(os.path.join(path, "labels", "*.tif")))
    assert len(image_paths) == len(label_paths) and len(image_paths) > 0
    return image_paths, label_paths


def get_synthmt_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        download: bool = False, **kwargs):
    """Get the SynthMT dataset for microtubule segmentation."""
    image_paths, label_paths = get_synthmt_paths(path, download)
    return default_segmentation_dataset(
        image_paths, None, label_paths, None, patch_shape,
        is_seg_dataset=False, ndim=2, **kwargs,
    )


def get_synthmt_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                       batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the SynthMT data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_synthmt_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
