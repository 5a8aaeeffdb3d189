"""LIVECell cell segmentation dataset (reference
torch_em/data/datasets/light_microscopy/livecell.py).

Phase-contrast microscopy with COCO-style instance annotations.
Publication: https://doi.org/10.1038/s41592-021-01249-6

The COCO annotations are converted with a pure-python decoder (polygon
rasterization via PIL, uncompressed RLE via numpy, compressed RLE through the
port's own ``utils/coco.py``) — pycocotools is not required in this rebuild.
"""

import json
import os
from shutil import copyfileobj
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....ops.host import label_consecutive
from ....utils import coco
from ....utils.io import _pil_draw, _pil_image
from .. import util

URLS = {
    "images": "http://livecell-dataset.s3.eu-central-1.amazonaws.com/LIVECell_dataset_2021/images.zip",
    "train": ("http://livecell-dataset.s3.eu-central-1.amazonaws.com/LIVECell_dataset_2021/annotations/"
              "LIVECell/livecell_coco_train.json"),
    "val": ("http://livecell-dataset.s3.eu-central-1.amazonaws.com/LIVECell_dataset_2021/annotations/"
            "LIVECell/livecell_coco_val.json"),
    "test": ("http://livecell-dataset.s3.eu-central-1.amazonaws.com/LIVECell_dataset_2021/annotations/"
             "LIVECell/livecell_coco_test.json"),
}
CHECKSUM = None

CELL_TYPES = ["A172", "BT474", "BV2", "Huh7", "MCF7", "SHSY5Y", "SkBr3", "SKOV3"]


def _download_annotation_file(path, split, download):
    annotation_file = os.path.join(path, f"{split}.json")
    if not os.path.exists(annotation_file):
        if not download:
            raise RuntimeError(f"Cannot find {annotation_file}, but download was set to False.")
        import requests

        print("Downloading livecell annotation file from", URLS[split])
        with requests.get(URLS[split], stream=True, timeout=300) as r:
            with open(annotation_file, "wb") as f:
                copyfileobj(r.raw, f)
    return annotation_file


def _annotation_to_mask(annotation, shape):
    """Decode a COCO segmentation (polygons, uncompressed or compressed RLE) to a mask."""
    seg = annotation["segmentation"]
    if isinstance(seg, list):  # polygons
        Image, ImageDraw = _pil_image(), _pil_draw()

        img = Image.new("1", (shape[1], shape[0]), 0)
        draw = ImageDraw.Draw(img)
        for poly in seg:
            pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
            if len(pts) >= 3:
                draw.polygon(pts, outline=1, fill=1)
        return np.asarray(img, dtype=bool)
    if isinstance(seg, dict):  # uncompressed or compressed RLE
        return coco.decode(seg).astype(bool)
    raise ValueError("Unsupported segmentation encoding.")


def _annotations_to_instances(image_metadata, annotations):
    shape = (image_metadata["height"], image_metadata["width"])
    seg = np.zeros(shape, dtype="uint32")
    sizes = [ann["area"] if ann.get("iscrowd", 0) == 0 else 1 for ann in annotations]
    for seg_id, i in enumerate(np.argsort(sizes), 1):
        mask = _annotation_to_mask(annotations[i], shape)
        seg[mask] = seg_id
    # filter small noise objects from overlapping annotations
    seg_ids, counts = np.unique(seg, return_counts=True)
    seg[np.isin(seg, seg_ids[counts < 50])] = 0
    return label_consecutive(seg).astype("uint16")


def _create_segmentations_from_annotations(annotation_file, image_folder, seg_folder, cell_types):
    Image = _pil_image()

    os.makedirs(seg_folder, exist_ok=True)
    with open(annotation_file) as f:
        coco = json.load(f)
    annotations_per_image = {}
    for ann in coco["annotations"]:
        annotations_per_image.setdefault(ann["image_id"], []).append(ann)

    image_paths, seg_paths = [], []
    for image_metadata in coco["images"]:
        file_name = image_metadata["file_name"]
        if cell_types is not None and not any(ct in file_name for ct in cell_types):
            continue
        sub_folder = file_name.split("_")[0]
        image_path = os.path.join(image_folder, sub_folder, file_name)
        assert os.path.exists(image_path), image_path
        seg_path = os.path.join(seg_folder, file_name)
        image_paths.append(image_path)
        seg_paths.append(seg_path)
        if os.path.exists(seg_path):
            continue
        seg = _annotations_to_instances(
            image_metadata, annotations_per_image.get(image_metadata["id"], [])
        )
        Image.fromarray(seg.astype("int32"), mode="I").save(seg_path)
    assert len(image_paths) == len(seg_paths) and len(image_paths) > 0
    return image_paths, seg_paths


def get_livecell_data(path: Union[os.PathLike, str], download: bool = False) -> None:
    """Download the LIVECell images."""
    os.makedirs(path, exist_ok=True)
    image_path = os.path.join(path, "images")
    if os.path.exists(image_path):
        return
    url = URLS["images"]
    zip_path = os.path.join(path, "livecell.zip")
    util.download_source(zip_path, url, download, checksum=CHECKSUM)
    util.unzip(zip_path, path, True)


def get_livecell_paths(
    path: Union[os.PathLike, str], split: str = "train",
    cell_types: Optional[Sequence[str]] = None, download: bool = False,
) -> Tuple[List[str], List[str]]:
    """Get paths to LIVECell images and converted instance segmentations."""
    assert split in ("train", "val", "test")
    if cell_types is not None:
        assert isinstance(cell_types, (list, tuple))
    get_livecell_data(path, download)
    annotation_file = _download_annotation_file(path, split, download)
    image_folder = os.path.join(path, "images", "livecell_train_val_images"
                                if split in ("train", "val") else "livecell_test_images")
    seg_folder = os.path.join(path, "annotations", split)
    return _create_segmentations_from_annotations(annotation_file, image_folder, seg_folder,
                                                  cell_types)


def get_livecell_dataset(
    path: Union[os.PathLike, str],
    split: str,
    patch_shape: Tuple[int, int],
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    cell_types: Optional[Sequence[str]] = None,
    label_dtype="int64",
    **kwargs,
):
    """Get the LIVECell dataset for cell segmentation."""
    image_paths, seg_paths = get_livecell_paths(path, split, cell_types, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, label_dtype = util.add_instance_label_transform(
        kwargs, add_binary_target=True, label_dtype=label_dtype,
        offsets=offsets, boundaries=boundaries, binary=binary,
    )
    return default_segmentation_dataset(
        image_paths, None, seg_paths, None, patch_shape, is_seg_dataset=False, ndim=2,
        label_dtype=label_dtype or "int64", **kwargs,
    )


def get_livecell_loader(
    path: Union[os.PathLike, str],
    split: str,
    patch_shape: Tuple[int, int],
    batch_size: int,
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    cell_types: Optional[Sequence[str]] = None,
    label_dtype="int64",
    **kwargs,
) -> DataLoader:
    """Get the LIVECell data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_livecell_dataset(
        path, split, patch_shape, download=download, offsets=offsets, boundaries=boundaries,
        binary=binary, cell_types=cell_types, label_dtype=label_dtype, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
