"""EVICAN dataset: cell and nucleus segmentation in brightfield microscopy
(reference torch_em/data/datasets/light_microscopy/evican.py).

Hosted at https://edmond.mpg.de (EVICAN2 / EVICAN60 annotation variants);
publication: https://doi.org/10.1093/bioinformatics/btaa225
"""

import json
import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image
from .livecell import _annotation_to_mask  # pure-python COCO decoding
from .. import util

URLS = {
    "images_train": "https://edmond.mpg.de/api/access/datafile/102910",
    "images_val": "https://edmond.mpg.de/api/access/datafile/102911",
    "images_eval": "https://edmond.mpg.de/api/access/datafile/102912",
    "annotations_evican2_train": "https://edmond.mpg.de/api/access/datafile/102915",
    "annotations_evican2_val": "https://edmond.mpg.de/api/access/datafile/102916",
    "annotations_evican2_eval_easy": "https://edmond.mpg.de/api/access/datafile/102918",
    "annotations_evican2_eval_medium": "https://edmond.mpg.de/api/access/datafile/102919",
    "annotations_evican2_eval_difficult": "https://edmond.mpg.de/api/access/datafile/102917",
    "annotations_evican60_train": "https://edmond.mpg.de/api/access/datafile/102921",
    "annotations_evican60_val": "https://edmond.mpg.de/api/access/datafile/102922",
    "annotations_evican60_eval_easy": "https://edmond.mpg.de/api/access/datafile/102924",
    "annotations_evican60_eval_medium": "https://edmond.mpg.de/api/access/datafile/102920",
    "annotations_evican60_eval_difficult": "https://edmond.mpg.de/api/access/datafile/102923",
}
ANNOTATION_TYPES = ["evican2", "evican60"]
SEGMENTATION_TYPES = ["cell", "nucleus"]
SPLITS = ["train", "val", "eval_easy", "eval_medium", "eval_difficult"]


def _download_images(path, split, download):
    image_split = "eval" if split.startswith("eval") else split
    image_dir = os.path.join(path, "images", image_split)
    if os.path.exists(image_dir):
        return image_dir
    os.makedirs(image_dir, exist_ok=True)
    zip_path = os.path.join(path, f"EVICAN_{image_split}.zip")
    util.download_source(zip_path, URLS[f"images_{image_split}"], download, checksum=None)
    util.unzip(zip_path, image_dir, remove=True)
    return image_dir


def _download_annotations(path, split, annotation_type, download):
    ann_dir = os.path.join(path, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    ann_file = os.path.join(ann_dir, f"instances_{split}_{annotation_type}.json")
    if not os.path.exists(ann_file):
        util.download_source(ann_file, URLS[f"annotations_{annotation_type}_{split}"],
                             download, checksum=None)
    return ann_file


def _create_segmentations(path, split, annotation_type, segmentation_type):
    Image = _pil_image()

    image_split = "eval" if split.startswith("eval") else split
    image_dir = os.path.join(path, "images", image_split)
    seg_dir = os.path.join(path, "segmentations", annotation_type, segmentation_type, split)
    if os.path.exists(seg_dir) and glob(os.path.join(seg_dir, "*.tif")):
        seg_paths = util.natsorted(glob(os.path.join(seg_dir, "*.tif")))
        image_paths = [os.path.join(image_dir, f"{Path(sp).stem}.jpg") for sp in seg_paths]
        return image_paths, seg_paths
    os.makedirs(seg_dir, exist_ok=True)

    ann_file = os.path.join(path, "annotations", f"instances_{split}_{annotation_type}.json")
    with open(ann_file) as f:
        coco = json.load(f)
    wanted_cats = {
        c["id"] for c in coco["categories"]
        if segmentation_type.lower() in c.get("name", "").lower()
    }
    ann_by_image = {}
    for ann in coco["annotations"]:
        if ann["category_id"] in wanted_cats:
            ann_by_image.setdefault(ann["image_id"], []).append(ann)

    image_paths, seg_paths = [], []
    for image_metadata in coco["images"]:
        fname = image_metadata["file_name"]
        image_path = os.path.join(image_dir, fname)
        if not os.path.exists(image_path):
            continue
        shape = (image_metadata["height"], image_metadata["width"])
        seg = np.zeros(shape, dtype="uint16")
        for seg_id, ann in enumerate(ann_by_image.get(image_metadata["id"], []), 1):
            try:
                mask = _annotation_to_mask(ann, shape)
            except ValueError:  # compressed RLE needs pycocotools; skip such objects
                continue
            seg[mask] = seg_id
        seg_path = os.path.join(seg_dir, f"{Path(fname).stem}.tif")
        Image.fromarray(seg.astype("int32"), mode="I").save(seg_path)
        image_paths.append(image_path)
        seg_paths.append(seg_path)
    return util.natsorted(image_paths), util.natsorted(seg_paths)


def get_evican_data(path: Union[os.PathLike, str], split: str = "train",
                    annotation_type: str = "evican2",
                    download: bool = False) -> str:
    """Download the EVICAN images and annotations."""
    assert split in SPLITS and annotation_type in ANNOTATION_TYPES
    _download_images(path, split, download)
    _download_annotations(path, split, annotation_type, download)
    return path


def get_evican_paths(path: Union[os.PathLike, str], split: str = "train",
                     annotation_type: str = "evican2",
                     segmentation_type: str = "cell",
                     download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the EVICAN images and instance masks."""
    assert segmentation_type in SEGMENTATION_TYPES
    get_evican_data(path, split, annotation_type, download)
    return _create_segmentations(path, split, annotation_type, segmentation_type)


def get_evican_dataset(path: Union[os.PathLike, str], patch_shape, split: str = "train",
                       annotation_type: str = "evican2", segmentation_type: str = "cell",
                       download: bool = False, **kwargs):
    """Get the EVICAN dataset for cell/nucleus segmentation."""
    image_paths, seg_paths = get_evican_paths(path, split, annotation_type,
                                              segmentation_type, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(image_paths, None, seg_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_evican_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                      split: str = "train", annotation_type: str = "evican2",
                      segmentation_type: str = "cell", download: bool = False,
                      **kwargs) -> DataLoader:
    """Get the EVICAN data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_evican_dataset(path, patch_shape, split=split, annotation_type=annotation_type,
                            segmentation_type=segmentation_type, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
