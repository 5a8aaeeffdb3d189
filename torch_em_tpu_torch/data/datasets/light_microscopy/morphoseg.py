"""MorphoSeg dataset: segmentation of NTERA-2 pluripotent stem cells in
brightfield microscopy (reference
torch_em/data/datasets/light_microscopy/morphoseg.py).

Hosted at https://doi.org/10.15131/shef.data.25604421. Polygon ROI json
annotations are rasterized (via PIL, instead of skimage.draw) into
per-image instance masks; only the training split carries annotations.
"""

import json
import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_draw, _pil_image, load_image
from .. import util

URLS = {
    "train": "https://ndownloader.figshare.com/files/45654198",
    "test": "https://ndownloader.figshare.com/files/45654201",
    "rois": "https://ndownloader.figshare.com/files/45654207",
}


def _rois_to_masks(data_dir):
    """Rasterize the polygon ROI json files into instance masks."""
    Image, ImageDraw = _pil_image(), _pil_draw()
    roi_dir = os.path.join(data_dir, "roi_jsons_combined")
    mask_dir = os.path.join(data_dir, "masks")
    os.makedirs(mask_dir, exist_ok=True)
    img_dir = os.path.join(data_dir, "training_dataset")
    for json_path in util.natsorted(glob(os.path.join(roi_dir, "*_ROI.json"))):
        stem = os.path.basename(json_path).replace("_ROI.json", "")
        img_path = os.path.join(img_dir, stem + ".tif")
        if not os.path.exists(img_path):
            img_path = os.path.join(img_dir, stem + ".MP.tif")
            if not os.path.exists(img_path):
                continue
        img = np.asarray(load_image(img_path))
        h, w = img.shape[:2]
        with open(json_path) as f:
            rois = json.load(f)
        mask = Image.new("I", (w, h), 0)
        drawer = ImageDraw.Draw(mask)
        for instance_id, roi in enumerate(rois, start=1):
            pts = [(float(x), float(y)) for x, y in roi["points"]]
            drawer.polygon(pts, fill=instance_id)
        mask.save(os.path.join(mask_dir, stem + "_mask.tif"))


def get_morphoseg_data(path: Union[os.PathLike, str], split: str,
                       download: bool = False) -> str:
    """Download the MorphoSeg data for a split."""
    assert split in ("train", "test"), f"'{split}' is not a valid split."
    data_dir = os.path.join(path, split)
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, f"{split}_dataset.zip")
    util.download_source(zip_path, URLS[split], download)
    util.unzip(zip_path, data_dir)
    if split == "train":
        roi_zip = os.path.join(path, "Training_ROIs_json.zip")
        util.download_source(roi_zip, URLS["rois"], download)
        util.unzip(roi_zip, data_dir)
        _rois_to_masks(data_dir)
    return data_dir


def get_morphoseg_paths(path: Union[os.PathLike, str], split: str,
                        download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the MorphoSeg images and instance masks (train only)."""
    if split == "test":
        raise RuntimeError("The MorphoSeg test split does not contain segmentation masks.")
    data_dir = get_morphoseg_data(path, split, download)
    mask_dir = os.path.join(data_dir, "masks")
    label_paths = util.natsorted(glob(os.path.join(mask_dir, "*_mask.tif")))
    if not label_paths:
        raise RuntimeError(f"No mask files found in {mask_dir}.")
    img_dir = os.path.join(data_dir, "training_dataset")
    raw_paths = []
    for lp in label_paths:
        stem = os.path.basename(lp).replace("_mask.tif", "")
        candidate = os.path.join(img_dir, stem + ".tif")
        if not os.path.exists(candidate):
            candidate = os.path.join(img_dir, stem + ".MP.tif")
        raw_paths.append(candidate)
    missing = [r for r in raw_paths if not os.path.exists(r)]
    if missing:
        raise RuntimeError(f"{len(missing)} image file(s) not found for their masks.")
    return raw_paths, label_paths


def get_morphoseg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          split: str = "train", download: bool = False, **kwargs):
    """Get the MorphoSeg dataset for stem-cell segmentation."""
    raw_paths, label_paths = get_morphoseg_paths(path, split, download)
    return default_segmentation_dataset(
        raw_paths, None, label_paths, None, patch_shape,
        is_seg_dataset=False, ndim=2, **kwargs,
    )


def get_morphoseg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         batch_size: int, split: str = "train",
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the MorphoSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_morphoseg_dataset(path, patch_shape, split=split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
