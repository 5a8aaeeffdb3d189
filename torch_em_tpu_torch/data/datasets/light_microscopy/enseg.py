"""ENSeg dataset: enteric neuron segmentation in mice
(reference torch_em/data/datasets/light_microscopy/enseg.py).

Located at https://www.kaggle.com/datasets/gustavozanonifelipe/enseg-dataset;
publication: https://doi.org/10.3390/app15031046
"""

import base64
import io
import json
import os
from glob import glob
from typing import List, Optional, Sequence, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_draw, _pil_image
from .. import util

KAGGLE_DATASET_NAME = "gustavozanonifelipe/enseg-dataset"
ANIMAL_TAGS = ["2C", "4C", "5C", "22TW", "23TW", "28TW"]


def _process_json(json_path, image_dir, seg_dir):
    """Extract the embedded image and rasterize the LabelMe polygons."""
    Image, ImageDraw = _pil_image(), _pil_draw()

    with open(json_path) as f:
        data = json.load(f)
    animal_tag = data["animalTag"]
    stem = f"{animal_tag}_{os.path.basename(json_path).replace('.json', '')}"
    image_path = os.path.join(image_dir, f"{stem}.png")
    seg_path = os.path.join(seg_dir, f"{stem}.tif")
    if not os.path.exists(image_path):
        image = Image.open(io.BytesIO(base64.b64decode(data["imageData"])))
        image.save(image_path)
    if not os.path.exists(seg_path):
        shape = (data["imageHeight"], data["imageWidth"])
        seg = Image.new("I", (shape[1], shape[0]), 0)
        draw = ImageDraw.Draw(seg)
        for seg_id, obj in enumerate(data["shapes"], 1):
            pts = [(float(x), float(y)) for x, y in obj["points"]]
            if len(pts) >= 3:
                draw.polygon(pts, outline=seg_id, fill=seg_id)
        seg.save(seg_path)


def get_enseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the ENSeg data (kaggle)."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(path, KAGGLE_DATASET_NAME, download)
    util.unzip(os.path.join(path, "enseg-dataset.zip"), data_dir)
    return data_dir


def get_enseg_paths(path: Union[os.PathLike, str],
                    animal_tags: Optional[Sequence[str]] = None,
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the ENSeg images and instance masks, optionally filtered
    by animal tags (control: 2C/4C/5C, tumor: 22TW/23TW/28TW)."""
    data_dir = get_enseg_data(path, download)
    image_dir = os.path.join(path, "images")
    seg_dir = os.path.join(path, "segmentations")
    if not os.path.exists(image_dir) or not os.path.exists(seg_dir):
        os.makedirs(image_dir, exist_ok=True)
        os.makedirs(seg_dir, exist_ok=True)
        json_paths = util.natsorted(glob(os.path.join(data_dir, "*", "*.json")))
        assert json_paths, f"No JSON annotation files found in {data_dir}"
        for json_path in json_paths:
            _process_json(json_path, image_dir, seg_dir)
    seg_paths = util.natsorted(glob(os.path.join(seg_dir, "*.tif")))
    image_paths = util.natsorted(glob(os.path.join(image_dir, "*.png")))
    assert len(image_paths) == len(seg_paths) and len(image_paths) > 0
    if animal_tags is not None:
        for tag in animal_tags:
            assert tag in ANIMAL_TAGS, f"'{tag}' is not a valid animal tag."
        keep = tuple(f"{tag}_" for tag in animal_tags)
        pairs = [(i, s) for i, s in zip(image_paths, seg_paths)
                 if os.path.basename(i).startswith(keep)]
        image_paths = [p[0] for p in pairs]
        seg_paths = [p[1] for p in pairs]
    return image_paths, seg_paths


def get_enseg_dataset(path: Union[os.PathLike, str], patch_shape,
                      animal_tags: Optional[Sequence[str]] = None,
                      download: bool = False, **kwargs):
    """Get the ENSeg dataset for enteric neuron segmentation."""
    image_paths, seg_paths = get_enseg_paths(path, animal_tags, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(image_paths, None, seg_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_enseg_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                     animal_tags: Optional[Sequence[str]] = None,
                     download: bool = False, **kwargs) -> DataLoader:
    """Get the ENSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_enseg_dataset(path, patch_shape, animal_tags=animal_tags,
                           download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
