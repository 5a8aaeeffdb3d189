"""PanopTILs dataset: panoptic segmentation of nuclei and tissue regions for
tumor-infiltrating lymphocyte scoring in breast cancer H&E
(reference torch_em/data/datasets/histopathology/panoptils.py).

Uses the refined parquet release at
https://huggingface.co/datasets/histolytics-hub/panoptils_refined.
"""

import os
from glob import glob
from io import BytesIO
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util
from ....utils.io import _pil_image

URL = ("https://huggingface.co/datasets/histolytics-hub/panoptils_refined"
       "/resolve/main/panoptils_refined.parquet")
LABEL_CHOICES = ("instances", "type", "semantic")


def _create_images_from_parquet(path):
    import pandas as pd

    Image = _pil_image()
    image_dir = os.path.join(path, "images")
    inst_dir = os.path.join(path, "instances")
    type_dir = os.path.join(path, "types")
    sem_dir = os.path.join(path, "semantic")
    for d in (image_dir, inst_dir, type_dir, sem_dir):
        os.makedirs(d, exist_ok=True)
    df = pd.read_parquet(os.path.join(path, "panoptils_refined.parquet"))
    for idx, row in df.iterrows():
        sample_id = f"{idx:05d}"
        img_path = os.path.join(image_dir, f"{sample_id}.tif")
        if os.path.exists(img_path):
            continue
        img = np.array(Image.open(BytesIO(row["image"])).convert("RGB"))
        inst = np.array(Image.open(BytesIO(row["inst"]))).astype("int32")
        ntype = np.array(Image.open(BytesIO(row["type"]))).astype("uint8")
        sem = np.array(Image.open(BytesIO(row["sem"]))).astype("uint8")
        Image.fromarray(img).save(img_path)
        Image.fromarray(inst, mode="I").save(os.path.join(inst_dir, f"{sample_id}.tif"))
        Image.fromarray(ntype).save(os.path.join(type_dir, f"{sample_id}.tif"))
        Image.fromarray(sem).save(os.path.join(sem_dir, f"{sample_id}.tif"))


def get_panoptils_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the PanopTILs parquet and extract images and masks as tifs."""
    os.makedirs(path, exist_ok=True)
    parquet_path = os.path.join(path, "panoptils_refined.parquet")
    if not os.path.exists(parquet_path):
        util.download_source(parquet_path, URL, download)
    image_dir = os.path.join(path, "images")
    if not os.path.exists(image_dir) or len(glob(os.path.join(image_dir, "*.tif"))) == 0:
        _create_images_from_parquet(path)
    return path


def get_panoptils_paths(path: Union[os.PathLike, str],
                        label_choice: str = "instances",
                        download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the PanopTILs images and the chosen label masks."""
    assert label_choice in LABEL_CHOICES, \
        f"'{label_choice}' is not valid. Choose from {LABEL_CHOICES}."
    get_panoptils_data(path, download)
    label_dir = label_choice if label_choice != "type" else "types"
    image_paths = util.natsorted(glob(os.path.join(path, "images", "*.tif")))
    label_paths = util.natsorted(glob(os.path.join(path, label_dir, "*.tif")))
    assert len(image_paths) == len(label_paths) and len(image_paths) > 0
    return image_paths, label_paths


def get_panoptils_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          label_choice: str = "instances",
                          download: bool = False, **kwargs):
    """Get the PanopTILs dataset for panoptic TIL segmentation."""
    image_paths, label_paths = get_panoptils_paths(path, label_choice, download)
    if label_choice == "instances":
        kwargs, _ = util.add_instance_label_transform(kwargs, add_binary_target=True)
    kwargs = util.update_kwargs(kwargs, "ndim", 2)
    return default_segmentation_dataset(
        image_paths, None, label_paths, None, patch_shape,
        is_seg_dataset=label_choice != "instances", **kwargs,
    )


def get_panoptils_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         batch_size: int, label_choice: str = "instances",
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the PanopTILs data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_panoptils_dataset(path, patch_shape, label_choice=label_choice,
                               download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
