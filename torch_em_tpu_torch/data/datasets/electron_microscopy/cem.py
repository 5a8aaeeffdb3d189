"""CEM / MitoLab datasets: mitochondria segmentation corpora from the
CEM-MitoLab publication (reference
torch_em/data/datasets/electron_microscopy/cem.py).

- CEM-MitoLab training data (2D patches): https://www.ebi.ac.uk/empiar/EMPIAR-11037/
- MitoLab benchmark volumes: https://www.ebi.ac.uk/empiar/EMPIAR-10982/
Publication: https://doi.org/10.1016/j.cels.2022.12.006
"""

import json
import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import load_image
from .. import util
from ..util import _train_test_split

BENCHMARK_DATASETS = {
    1: "mito_benchmarks/c_elegans",
    2: "mito_benchmarks/fly_brain",
    3: "mito_benchmarks/glycolytic_muscle",
    4: "mito_benchmarks/hela_cell",
    5: "mito_benchmarks/lucchi_pp",
    6: "mito_benchmarks/salivary_gland",
    7: "tem_benchmark",
}
BENCHMARK_SHAPES = {
    1: (256, 256, 256),
    2: (256, 255, 255),
    3: (302, 383, 765),
    4: (256, 256, 256),
    5: (165, 768, 1024),
    6: (1260, 1081, 1200),
    7: (224, 224),  # minimal square shape that fits the 2d data
}


def get_mitolab_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the CEM-MitoLab training data (EMPIAR-11037)."""
    data_path = util.download_source_empiar(path, "11037", download)
    zip_path = os.path.join(data_path, "data/cem_mitolab.zip")
    if os.path.exists(zip_path):
        util.unzip(zip_path, data_path, remove=True)
    data_root = os.path.join(data_path, "cem_mitolab")
    assert os.path.exists(data_root), data_root
    return data_root


def _get_all_images(path):
    raw_paths, label_paths = [], []
    for folder in glob(os.path.join(path, "*")):
        if not os.path.isdir(folder):  # the non_empty_images.json cache lives beside the datasets
            continue
        images = sorted(glob(os.path.join(folder, "images", "*.tiff")))
        labels = sorted(glob(os.path.join(folder, "masks", "*.tiff")))
        assert len(images) == len(labels) and len(images) > 0
        raw_paths.extend(images)
        label_paths.extend(labels)
    return raw_paths, label_paths


def _get_non_empty_images(path):
    """Filter out patches without any annotated mitochondria (cached)."""
    save_path = os.path.join(path, "non_empty_images.json")
    if os.path.exists(save_path):
        with open(save_path) as f:
            saved = json.load(f)
        return ([os.path.join(path, p) for p in saved["images"]],
                [os.path.join(path, p) for p in saved["labels"]])

    raw_paths, label_paths = [], []
    for folder in glob(os.path.join(path, "*")):
        if not os.path.isdir(folder):
            continue
        images = sorted(glob(os.path.join(folder, "images", "*.tiff")))
        labels = sorted(glob(os.path.join(folder, "masks", "*.tiff")))
        for im, lab in zip(images, labels):
            if len(np.unique(np.asarray(load_image(lab)))) > 1:
                raw_paths.append(im)
                label_paths.append(lab)

    with open(save_path, "w") as f:
        json.dump({"images": [os.path.relpath(p, path) for p in raw_paths],
                   "labels": [os.path.relpath(p, path) for p in label_paths]}, f)
    return raw_paths, label_paths


def get_mitolab_paths(path: Union[os.PathLike, str], split: str, val_fraction: float = 0.05,
                      download: bool = False,
                      discard_empty_images: bool = True) -> Tuple[List[str], List[str]]:
    """Get paths to the CEM-MitoLab 2D patches for a split ('train' / 'val')."""
    data_path = get_mitolab_data(path, download)
    if discard_empty_images:
        raw_paths, label_paths = _get_non_empty_images(data_path)
    else:
        raw_paths, label_paths = _get_all_images(data_path)
    if split is not None:
        raw_train, raw_val, labels_train, labels_val = _train_test_split(
            raw_paths, label_paths, test_size=val_fraction, random_state=42)
        raw_paths, label_paths = (raw_train, labels_train) if split == "train" \
            else (raw_val, labels_val)
    assert len(raw_paths) > 0 and len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_benchmark_data(path: Union[os.PathLike, str], dataset_id: int,
                       download: bool = False) -> str:
    """Download one of the MitoLab benchmark datasets (EMPIAR-10982)."""
    data_path = util.download_source_empiar(path, "10982", download)
    return os.path.join(data_path, "data", BENCHMARK_DATASETS[dataset_id])


def get_benchmark_paths(path: Union[os.PathLike, str], dataset_id: int,
                        download: bool = False):
    """Get paths/keys for a MitoLab benchmark dataset; datasets 1-6 are 3D
    volumes, 7 is a 2D image collection."""
    dataset_path = get_benchmark_data(path, dataset_id, download)
    if dataset_id in range(1, 7):
        name = os.path.basename(dataset_path)
        return (os.path.join(dataset_path, f"{name}_em.tif"),
                os.path.join(dataset_path, f"{name}_mito.tif"), None, None, True)
    return (os.path.join(dataset_path, "images"), os.path.join(dataset_path, "masks"),
            "*.tiff", "*.tiff", False)


def get_mitolab_dataset(path: Union[os.PathLike, str], split: str,
                        patch_shape: Tuple[int, int] = (224, 224),
                        val_fraction: float = 0.05, download: bool = False,
                        discard_empty_images: bool = True, **kwargs):
    """Get the CEM-MitoLab dataset for mitochondria segmentation."""
    assert split in ("train", "val", None)
    raw_paths, label_paths = get_mitolab_paths(path, split, val_fraction, download,
                                               discard_empty_images)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_mitolab_loader(path: Union[os.PathLike, str], split: str, batch_size: int,
                       patch_shape: Tuple[int, int] = (224, 224),
                       val_fraction: float = 0.05, download: bool = False,
                       discard_empty_images: bool = True, **kwargs) -> DataLoader:
    """Get the CEM-MitoLab data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_mitolab_dataset(path, split, patch_shape, val_fraction=val_fraction,
                             download=download, discard_empty_images=discard_empty_images,
                             **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)


def get_benchmark_dataset(path: Union[os.PathLike, str], dataset_id: int,
                          patch_shape: Tuple[int, ...], download: bool = False, **kwargs):
    """Get one of the MitoLab benchmark datasets."""
    if dataset_id not in BENCHMARK_DATASETS:
        raise ValueError(f"Invalid benchmark dataset id {dataset_id}.")
    raw_paths, label_paths, raw_key, label_key, is_seg = get_benchmark_paths(
        path, dataset_id, download)
    kwargs = util.ensure_transforms(ndim=3 if is_seg else 2, **kwargs)
    return default_segmentation_dataset(raw_paths, raw_key, label_paths, label_key,
                                        patch_shape, is_seg_dataset=is_seg, **kwargs)


def get_benchmark_loader(path: Union[os.PathLike, str], dataset_id: int,
                         patch_shape: Tuple[int, ...], batch_size: int,
                         download: bool = False, **kwargs) -> DataLoader:
    """Get a MitoLab benchmark data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_benchmark_dataset(path, dataset_id, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
