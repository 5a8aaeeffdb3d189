"""BALF dataset: cytology cell segmentation in bronchoalveolar lavage fluid
(reference torch_em/data/datasets/light_microscopy/balf.py).

Located at https://zenodo.org/records/14871206;
publication: https://doi.org/10.1038/s41597-025-05452-4
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, _pil_draw, _pil_image, load_image
from .. import util

URLS = {
    "images": "https://zenodo.org/records/14871206/files/Images.rar",
    "labels": "https://zenodo.org/records/14871206/files/Labels.rar",
}
CELL_TYPES = [
    "erythrocyte", "ciliated_columnar_epithelial", "squamous_epithelial",
    "macrophage", "lymphocyte", "neutrophil", "eosinophil",
]
SPLITS = ["train", "val"]


def _create_data_from_yolo(image_dir, label_dir, data_dir):
    """Rasterize the YOLO polygon annotations into instance + semantic masks
    (larger polygons drawn first so overlapping small cells stay on top)."""
    h5py = _h5py()
    Image, ImageDraw = _pil_image(), _pil_draw()

    os.makedirs(data_dir, exist_ok=True)
    label_paths = util.natsorted(glob(os.path.join(label_dir, "*.txt")))
    assert label_paths, f"No label files found in {label_dir}"
    data_paths = []
    for label_path in label_paths:
        stem = os.path.splitext(os.path.basename(label_path))[0]
        image_path = os.path.join(image_dir, f"{stem}.jpg")
        assert os.path.exists(image_path), f"Image not found: {image_path}"
        data_path = os.path.join(data_dir, f"{stem}.h5")
        data_paths.append(data_path)
        if os.path.exists(data_path):
            continue
        image = np.asarray(load_image(image_path))
        h, w = image.shape[:2]
        with open(label_path) as f:
            lines = [ln.strip().split() for ln in f if ln.strip()]
        polygons = []
        for parts in lines:
            class_id = int(parts[0])
            coords = [float(x) for x in parts[1:]]
            pts = [(coords[i] * w, coords[i + 1] * h) for i in range(0, len(coords) - 1, 2)]
            if len(pts) < 3:
                continue
            # polygon area via the shoelace formula (for draw ordering)
            xs = np.array([p[0] for p in pts])
            ys = np.array([p[1] for p in pts])
            area = 0.5 * abs(np.dot(xs, np.roll(ys, 1)) - np.dot(ys, np.roll(xs, 1)))
            polygons.append((pts, area, class_id))

        inst_img = Image.new("I", (w, h), 0)
        sem_img = Image.new("I", (w, h), 0)
        inst_draw = ImageDraw.Draw(inst_img)
        sem_draw = ImageDraw.Draw(sem_img)
        sorting = np.argsort([p[1] for p in polygons])[::-1]
        for seg_id, idx in enumerate(sorting, 1):
            pts, _, class_id = polygons[idx]
            inst_draw.polygon(pts, outline=seg_id, fill=seg_id)
            sem_draw.polygon(pts, outline=class_id + 1, fill=class_id + 1)

        with h5py.File(data_path, "w") as f:
            f.create_dataset("raw", data=image.transpose(2, 0, 1), compression="gzip")
            f.create_dataset("labels/instances",
                             data=np.asarray(inst_img, dtype="uint16"), compression="gzip")
            f.create_dataset("labels/semantic",
                             data=np.asarray(sem_img, dtype="uint16"), compression="gzip")
    return util.natsorted(data_paths)


def get_balf_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the BALF data (rar archives)."""
    for key in URLS:
        fname = URLS[key].rsplit("/", 1)[-1]
        dirname = os.path.splitext(fname)[0].lower()
        if os.path.exists(os.path.join(path, dirname)):
            continue
        os.makedirs(path, exist_ok=True)
        rar_path = os.path.join(path, fname)
        util.download_source(rar_path, URLS[key], download, checksum=None)
        util.unzip_rarfile(rar_path, path)
    return path


def get_balf_paths(path: Union[os.PathLike, str], split: str = "train",
                   download: bool = False) -> List[str]:
    """Get paths to the BALF volumes for a split ('train' / 'val')."""
    assert split in SPLITS, f"'{split}' is not a valid split. Choose from {SPLITS}."
    get_balf_data(path, download)
    image_dir = os.path.join(path, "images", split)
    label_dir = os.path.join(path, "labels", split)
    data_dir = os.path.join(path, "data", split)
    return _create_data_from_yolo(image_dir, label_dir, data_dir)


def get_balf_dataset(path: Union[os.PathLike, str], patch_shape, split: str = "train",
                     label_choice: str = "instances", download: bool = False, **kwargs):
    """Get the BALF dataset for cytology segmentation."""
    paths = get_balf_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, f"labels/{label_choice}",
                                        patch_shape, ndim=2, with_channels=True, **kwargs)


def get_balf_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                    split: str = "train", label_choice: str = "instances",
                    download: bool = False, **kwargs) -> DataLoader:
    """Get the BALF data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_balf_dataset(path, patch_shape, split=split, label_choice=label_choice,
                          download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
