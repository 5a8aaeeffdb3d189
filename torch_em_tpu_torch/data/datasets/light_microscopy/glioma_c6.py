"""Glioma C6 dataset: glioma cell segmentation in phase contrast
(reference torch_em/data/datasets/light_microscopy/glioma_c6.py).

Located at https://zenodo.org/records/15083188;
publication: https://doi.org/10.48550/arXiv.2511.07286
"""

import json
import os
from collections import defaultdict
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_draw, _pil_image
from .. import util

URL = "https://zenodo.org/records/15083188/files/dataset.zip?download=1"
CHECKSUM = None


def _coco_to_instance_masks(image_dir, annotation_file, mask_dir):
    """Convert COCO polygon annotations to per-image instance tif masks;
    only cell annotations are kept (nucleus 'cell_part' entries skipped)."""
    Image, ImageDraw = _pil_image(), _pil_draw()

    with open(annotation_file) as f:
        coco = json.load(f)
    cell_cat_ids = {c["id"] for c in coco["categories"] if c.get("supercategory") != "cell_part"}
    ann_by_image = defaultdict(list)
    for ann in coco["annotations"]:
        if ann["category_id"] in cell_cat_ids:
            ann_by_image[ann["image_id"]].append(ann)
    os.makedirs(mask_dir, exist_ok=True)

    for img_info in coco["images"]:
        h, w = img_info["height"], img_info["width"]
        img = Image.new("I", (w, h), 0)
        draw = ImageDraw.Draw(img)
        instance_id = 1
        for ann in ann_by_image[img_info["id"]]:
            segs = ann.get("segmentation", [])
            if isinstance(segs, dict):
                continue  # compressed RLE would require pycocotools
            for seg in segs:
                pts = [(seg[i], seg[i + 1]) for i in range(0, len(seg) - 1, 2)]
                if len(pts) >= 3:
                    draw.polygon(pts, outline=instance_id, fill=instance_id)
                    instance_id += 1
        mask_name = os.path.splitext(os.path.basename(img_info["file_name"]))[0] + "_mask.tif"
        img.save(os.path.join(mask_dir, mask_name))


def get_glioma_c6_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the Glioma C6 data and rasterize the COCO annotations."""
    data_dir = os.path.join(path, "GliomaC6")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(data_dir, exist_ok=True)
    zip_path = os.path.join(path, "glioma_c6_dataset.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, data_dir)
    for ann_file in util.natsorted(glob(os.path.join(data_dir, "**", "*.json"), recursive=True)):
        subset_dir = os.path.dirname(ann_file)
        image_dir = os.path.join(subset_dir, "images")
        if not os.path.isdir(image_dir):
            image_dir = subset_dir
        split_name = os.path.splitext(os.path.basename(ann_file))[0]
        _coco_to_instance_masks(image_dir, ann_file, os.path.join(subset_dir, "masks", split_name))
    return data_dir


def get_glioma_c6_paths(path: Union[os.PathLike, str], subset: str = "spec",
                        split: Optional[str] = None,
                        download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the Glioma C6 images and masks (subset 'spec' with
    train/val/test splits, or 'gen' for the generalization set)."""
    data_dir = get_glioma_c6_data(path, download)
    dataset_dir = os.path.join(data_dir, "dataset", subset)
    if not os.path.isdir(dataset_dir):
        raise RuntimeError(f"Could not find '{subset}' subset at {dataset_dir}.")

    if subset == "gen":
        raw_paths = util.natsorted(glob(os.path.join(dataset_dir, "images", "*.tif")))
        label_paths = util.natsorted(glob(os.path.join(dataset_dir, "masks", "anno_gen", "*.tif")))
    else:
        if split is None:
            raw_paths, label_paths = [], []
            for s in ("train", "val", "test"):
                rp, lp = get_glioma_c6_paths(path, subset, s, download)
                raw_paths.extend(rp)
                label_paths.extend(lp)
            return raw_paths, label_paths
        split_dir_name = "valid" if split == "val" else split
        split_dir = os.path.join(dataset_dir, split_dir_name)
        raw_paths = util.natsorted(glob(os.path.join(split_dir, "images", "*.tif")))
        label_paths = util.natsorted(
            glob(os.path.join(split_dir, "masks", f"anno_{split_dir_name}", "*.tif")))
    if len(raw_paths) == 0:
        raise RuntimeError(f"No images found for subset='{subset}', split='{split}'.")
    return raw_paths, label_paths


def get_glioma_c6_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          subset: str = "spec", split: Optional[str] = None,
                          download: bool = False, **kwargs):
    """Get the Glioma C6 dataset for cell segmentation."""
    raw_paths, label_paths = get_glioma_c6_paths(path, subset, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_glioma_c6_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         batch_size: int, subset: str = "spec",
                         split: Optional[str] = None, download: bool = False,
                         **kwargs) -> DataLoader:
    """Get the Glioma C6 data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_glioma_c6_dataset(path, patch_shape, subset=subset, split=split,
                               download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
