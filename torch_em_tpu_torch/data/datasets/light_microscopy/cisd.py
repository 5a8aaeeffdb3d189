"""CISD dataset: cyst instance segmentation in darkfield microscopy
(reference torch_em/data/datasets/light_microscopy/cisd.py).

Hosted at https://zenodo.org/records/5938893. Uncompressed RLE annotations
from CISD.json are decoded to per-image instance tifs; the RGB jpgs are
converted to grayscale tifs so shapes match the 2D masks.
"""

import json
import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = "https://zenodo.org/records/5938893/files/CISD.zip"
MODES = ("center_slice", "edf")


def get_cisd_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the CISD data."""
    data_dir = os.path.join(path, "CISD")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "CISD.zip")
    util.download_source(zip_path, URL, download)
    util.unzip(zip_path, path)
    return data_dir


def _decode_rle(rle_counts, height, width):
    """Decode an uncompressed row-major RLE mask to a 2D array."""
    flat = np.zeros(height * width, dtype=np.uint8)
    pos = 0
    for i, count in enumerate(rle_counts):
        if i % 2 == 1:
            flat[pos:pos + count] = 1
        pos += count
    return flat.reshape((height, width), order="C")


def _convert_annotations(data_dir, mode):
    Image = _pil_image()
    label_dir = os.path.join(data_dir, f"{mode}_labels")
    if os.path.exists(label_dir) and len(glob(os.path.join(label_dir, "*.tif"))) > 0:
        return label_dir
    os.makedirs(label_dir, exist_ok=True)
    json_path = os.path.join(data_dir, "CISD.json")
    if not os.path.exists(json_path):
        raise RuntimeError(f"Annotation file not found: {json_path}")
    with open(json_path) as f:
        data = json.load(f)
    for asset in data["assets"]:
        base_name = os.path.splitext(asset["file_name"])[0]
        anns = asset.get("annotations", [])
        h = w = None
        for ann in anns:
            for item in ann.get("data", []):
                if "size" in item.get("mask", {}):
                    h, w = item["mask"]["size"]
                    break
            if h is not None:
                break
        if h is None:
            continue
        label = np.zeros((h, w), dtype=np.int32)
        inst_id = 1
        for ann in anns:
            for item in ann.get("data", []):
                mask_info = item.get("mask", {})
                counts = mask_info.get("counts", [])
                if not counts:
                    continue
                size = mask_info.get("size", [h, w])
                label[_decode_rle(counts, size[0], size[1]) > 0] = inst_id
                inst_id += 1
        Image.fromarray(label, mode="I").save(os.path.join(label_dir, f"{base_name}.tif"))
    return label_dir


def _convert_raw_to_grayscale(data_dir, mode):
    Image = _pil_image()
    gray_dir = os.path.join(data_dir, f"{mode}_gray")
    if os.path.exists(gray_dir) and len(glob(os.path.join(gray_dir, "*.tif"))) > 0:
        return gray_dir
    os.makedirs(gray_dir, exist_ok=True)
    for jpg_path in util.natsorted(glob(os.path.join(data_dir, mode, "*.jpg"))):
        img = np.asarray(load_image(jpg_path))
        if img.ndim == 3:
            img = (img[..., :3] @ np.array([0.2989, 0.5870, 0.1140])).astype(np.uint8)
        stem = os.path.splitext(os.path.basename(jpg_path))[0]
        Image.fromarray(img).save(os.path.join(gray_dir, f"{stem}.tif"))
    return gray_dir


def get_cisd_paths(path: Union[os.PathLike, str], mode: str = "center_slice",
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the CISD images and instance masks ('center_slice' or 'edf')."""
    if mode not in MODES:
        raise ValueError(f"Invalid mode '{mode}'. Choose from {MODES}.")
    data_dir = get_cisd_data(path, download)
    if not os.path.exists(os.path.join(data_dir, mode)):
        raise RuntimeError(f"Image directory for mode '{mode}' not found.")
    label_dir = _convert_annotations(data_dir, mode)
    raw_dir = _convert_raw_to_grayscale(data_dir, mode)
    raw_paths = util.natsorted(glob(os.path.join(raw_dir, "*.tif")))
    label_paths = util.natsorted(glob(os.path.join(label_dir, "*.tif")))
    # keep only matched stems (some images have no annotations).
    raw_stems = {os.path.splitext(os.path.basename(p))[0]: p for p in raw_paths}
    label_stems = {os.path.splitext(os.path.basename(p))[0]: p for p in label_paths}
    common = util.natsorted(list(set(raw_stems) & set(label_stems)))
    assert len(common) > 0
    return [raw_stems[s] for s in common], [label_stems[s] for s in common]


def get_cisd_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     mode: str = "center_slice", download: bool = False, **kwargs):
    """Get the CISD dataset for cyst instance segmentation."""
    raw_paths, label_paths = get_cisd_paths(path, mode, download)
    return default_segmentation_dataset(
        raw_paths, None, label_paths, None, patch_shape,
        is_seg_dataset=False, ndim=2, **kwargs,
    )


def get_cisd_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                    batch_size: int, mode: str = "center_slice",
                    download: bool = False, **kwargs) -> DataLoader:
    """Get the CISD data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_cisd_dataset(path, patch_shape, mode=mode, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
