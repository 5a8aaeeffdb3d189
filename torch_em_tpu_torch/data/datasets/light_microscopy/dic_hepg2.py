"""DIC HepG2 dataset: cell segmentation in differential interference
contrast microscopy (reference
torch_em/data/datasets/light_microscopy/dic_hepg2.py).

Publication: https://doi.org/10.1016/j.compbiomed.2024.109151
"""

import json
import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image
from .livecell import _annotations_to_instances  # pure-python COCO decoding
from .. import util

URL = "https://zenodo.org/records/13120679/files/2021-11-15_HepG2_Calcein_AM.zip"
CHECKSUM = "42b939d01c5fc2517dc3ad34bde596ac38dbeba2a96173f37e1b6dfe14cbe3a2"


def get_dic_hepg2_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the DIC HepG2 data."""
    data_dir = os.path.join(path, "2021-11-15_HepG2_Calcein_AM")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "2021-11-15_HepG2_Calcein_AM.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def _create_segmentations_from_coco_annotation(path, split):
    Image = _pil_image()

    base_dir = os.path.join(path, "2021-11-15_HepG2_Calcein_AM", "coco_format", split)
    image_folder = os.path.join(base_dir, "images")
    gt_folder = os.path.join(base_dir, "annotations")
    if os.path.exists(gt_folder):
        return image_folder, gt_folder
    os.makedirs(gt_folder, exist_ok=True)

    ann_file = os.path.join(base_dir, "annotations.json")
    assert os.path.exists(ann_file), ann_file
    with open(ann_file) as f:
        coco = json.load(f)
    annotations_per_image = {}
    for ann in coco["annotations"]:
        annotations_per_image.setdefault(ann["image_id"], []).append(ann)

    for image_metadata in coco["images"]:
        fname = image_metadata["file_name"]
        gt = _annotations_to_instances(
            image_metadata, annotations_per_image.get(image_metadata["id"], [])
        )
        gt_path = os.path.join(gt_folder, str(Path(fname).with_suffix(".tif")))
        Image.fromarray(gt.astype("int32"), mode="I").save(gt_path)
    return image_folder, gt_folder


def get_dic_hepg2_paths(path: Union[os.PathLike, str], split: str,
                        download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the DIC HepG2 images and instance labels."""
    assert split in ("train", "val", "test"), f"Invalid split: {split}"
    get_dic_hepg2_data(path, download)
    image_folder, gt_folder = _create_segmentations_from_coco_annotation(path, split)
    gt_paths = sorted(glob(os.path.join(gt_folder, "*.tif")))
    image_paths = [
        os.path.join(image_folder, str(Path(os.path.basename(p)).with_suffix(".png")))
        for p in gt_paths
    ]
    return image_paths, gt_paths


def get_dic_hepg2_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          split: str, offsets=None, boundaries: bool = False,
                          binary: bool = False, download: bool = False, **kwargs):
    """Get the DIC HepG2 dataset for cell segmentation."""
    image_paths, gt_paths = get_dic_hepg2_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_dic_hepg2_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         batch_size: int, split: str, offsets=None,
                         boundaries: bool = False, binary: bool = False,
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the DIC HepG2 data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_dic_hepg2_dataset(path, patch_shape, split, offsets=offsets,
                               boundaries=boundaries, binary=binary, download=download,
                               **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
