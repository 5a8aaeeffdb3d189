"""PAPILA dataset: optic cup / disc segmentation in fundus images
(reference torch_em/data/datasets/medical/papila.py).

Located at https://figshare.com/articles/dataset/PAPILA/14798004/2;
publication: https://doi.org/10.1038/s41597-022-01388-1
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util
from ....utils.io import _pil_draw, _pil_image

URL = "https://figshare.com/ndownloader/files/35013982"
CHECKSUM = "15b053dff496bc8e53eb8a8d0707ef73ba3d56c988eea92b65832c9c82852a7d"
_INPUT_SHAPE = (1934, 2576, 3)  # shape of the fundus images


def get_papila_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the PAPILA data."""
    data_dir = os.path.join(path, "PapilaDB-PAPILA-17f8fa7746adb20275b5b6a0d99dc9dfe3007e9f")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "papila.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def _contour_to_mask(contour_path, img_shape):
    """Rasterize a contour point list to a binary mask (PIL polygon fill)."""
    Image, ImageDraw = _pil_image(), _pil_draw()

    c = np.loadtxt(contour_path)
    img = Image.new("1", (img_shape[1], img_shape[0]), 0)
    ImageDraw.Draw(img).polygon([(float(x), float(y)) for x, y in c[:, :2]], outline=1, fill=1)
    return np.asarray(img, dtype="uint8")


def _preprocess_labels(data_dir, image_paths, task, expert_choice):
    Image = _pil_image()

    gt_dir = os.path.join(data_dir, "ground_truth")
    os.makedirs(gt_dir, exist_ok=True)
    gt_paths = []
    for image_path in image_paths:
        patient_id = Path(image_path).stem
        for gt_contour in sorted(glob(os.path.join(
                data_dir, "ExpertsSegmentations", "Contours",
                f"{patient_id}_{task}_{expert_choice}.txt"))):
            tmp_task = Path(gt_contour).stem.split("_")[1]
            gt_path = os.path.join(gt_dir, f"{patient_id}_{tmp_task}_{expert_choice}.tif")
            gt_paths.append(gt_path)
            if os.path.exists(gt_path):
                continue
            Image.fromarray(_contour_to_mask(gt_contour, _INPUT_SHAPE)).save(gt_path)
    return gt_paths


def get_papila_paths(path: Union[os.PathLike, str], split: str, task: str = "disc",
                     expert_choice: str = "exp1",
                     download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the PAPILA images and (contour-rasterized) masks;
    350/50/rest split."""
    assert expert_choice in ("exp1", "exp2"), f"Invalid expert: {expert_choice}"
    assert task in ("cup", "disc"), f"Invalid task: {task}"
    data_dir = get_papila_data(path, download)
    image_paths = sorted(glob(os.path.join(data_dir, "FundusImages", "*.jpg")))
    gt_paths = _preprocess_labels(data_dir, image_paths, task, expert_choice)
    if split == "train":
        image_paths, gt_paths = image_paths[:350], gt_paths[:350]
    elif split == "val":
        image_paths, gt_paths = image_paths[350:400], gt_paths[350:400]
    elif split == "test":
        image_paths, gt_paths = image_paths[400:], gt_paths[400:]
    else:
        raise ValueError(f"'{split}' is not a valid split.")
    assert len(image_paths) == len(gt_paths) and len(image_paths) > 0
    return image_paths, gt_paths


def get_papila_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                       split: str, task: str = "disc", expert_choice: str = "exp1",
                       resize_inputs: bool = False, download: bool = False, **kwargs):
    """Get the PAPILA dataset for optic cup/disc segmentation."""
    image_paths, gt_paths = get_papila_paths(path, split, task, expert_choice, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_papila_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                      batch_size: int, split: str, task: str = "disc",
                      expert_choice: str = "exp1", resize_inputs: bool = False,
                      download: bool = False, **kwargs) -> DataLoader:
    """Get the PAPILA data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_papila_dataset(path, patch_shape, split, task=task, expert_choice=expert_choice,
                            resize_inputs=resize_inputs, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
