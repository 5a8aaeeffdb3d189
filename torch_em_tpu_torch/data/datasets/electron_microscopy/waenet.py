"""WAE-NET dataset: semantic organelle segmentation across seven TEM
sub-datasets (reference
torch_em/data/datasets/electron_microscopy/waenet.py).

Located at https://zenodo.org/records/6603083;
publication: https://doi.org/10.1007/s00418-022-02148-3
"""

import os
from glob import glob
from shutil import rmtree
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URL = "https://zenodo.org/records/6603083/files/Datasets.zip"
CHECKSUM = None

DATASET_CLASS_NAMES = {
    1: ["background", "cytoplasm", "nucleus"],
    2: ["background", "cytoplasm", "chromosomes"],
    3: ["background", "cytoplasm", "nucleus", "mitochondria"],
    4: ["background", "cytoplasm", "nucleus"],
    5: ["background", "cytoplasm", "nucleus"],
    6: ["background", "cytoplasm", "nucleus"],
    7: ["background", "cytoplasm", "nucleus"],
}


def _get_dataset_dir(data_root, dataset_id):
    for dname in (f"Dataset {dataset_id}", f"Dataset_{dataset_id}", f"Dataset{dataset_id}",
                  f"D{dataset_id}", str(dataset_id)):
        d = os.path.join(data_root, dname)
        if os.path.exists(d):
            return d
    raise RuntimeError(f"Cannot find a sub-directory for dataset {dataset_id} in {data_root}.")


def _get_image_mask_dirs(dataset_dir):
    img_dir = next((os.path.join(dataset_dir, n) for n in
                    ("Images", "images", "Image", "image", "Raw", "raw")
                    if os.path.exists(os.path.join(dataset_dir, n))), None)
    mask_dir = next((os.path.join(dataset_dir, n) for n in
                     ("Ground truth mask", "Masks", "masks", "Mask", "mask",
                      "Labels", "labels", "Label", "label")
                     if os.path.exists(os.path.join(dataset_dir, n))), None)
    if img_dir is None or mask_dir is None:
        raise RuntimeError(f"Cannot find image/mask directories inside {dataset_dir}.")
    return img_dir, mask_dir


def _create_h5_files(data_root, dataset_id, out_dir):
    h5py = _h5py()

    dataset_dir = _get_dataset_dir(data_root, dataset_id)
    img_dir, mask_dir = _get_image_mask_dirs(dataset_dir)
    exts = ("*.tif", "*.tiff", "*.png")
    image_files = sorted(sum((glob(os.path.join(img_dir, e)) for e in exts), []))
    mask_files = sorted(sum((glob(os.path.join(mask_dir, e)) for e in exts), []))
    assert image_files and len(image_files) == len(mask_files)
    os.makedirs(out_dir, exist_ok=True)
    for img_path, mask_path in zip(image_files, mask_files):
        fname = os.path.splitext(os.path.basename(img_path))[0]
        out_path = os.path.join(out_dir, f"{fname}.h5")
        raw = np.asarray(load_image(img_path))
        if raw.ndim == 3:
            raw = raw[..., 0]
        labels = np.asarray(load_image(mask_path))
        if labels.ndim == 3:
            labels = labels[..., 0]
        unique_vals = np.sort(np.unique(labels))
        if not np.array_equal(unique_vals, np.arange(len(unique_vals))):
            new_labels = np.zeros_like(labels)
            for cls_idx, val in enumerate(unique_vals):
                new_labels[labels == val] = cls_idx
            labels = new_labels
        with h5py.File(out_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            grp = f.create_group("labels")
            for cls_idx, cls_name in enumerate(DATASET_CLASS_NAMES[dataset_id]):
                grp.create_dataset(cls_name, data=(labels == cls_idx).astype("uint8"),
                                   compression="gzip")


def get_waenet_data(path: Union[os.PathLike, str], dataset_id: int,
                    download: bool = False) -> str:
    """Download and preprocess one WAE-NET sub-dataset (1-7)."""
    if dataset_id not in DATASET_CLASS_NAMES:
        raise ValueError(f"Invalid dataset_id {dataset_id!r}; choose 1-7.")
    h5_dir = os.path.join(path, f"dataset_{dataset_id}")
    if os.path.exists(h5_dir) and glob(os.path.join(h5_dir, "*.h5")):
        return h5_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "Datasets.zip")
    util.download_source(zip_path, URL, download, checksum=CHECKSUM)
    extract_dir = os.path.join(path, "_extracted")
    util.unzip(zip_path, extract_dir, remove=True)
    subdirs = [d for d in os.listdir(extract_dir)
               if os.path.isdir(os.path.join(extract_dir, d))]
    data_root = os.path.join(extract_dir, subdirs[0]) if subdirs else extract_dir
    for ds_id in DATASET_CLASS_NAMES:
        _create_h5_files(data_root, ds_id, os.path.join(path, f"dataset_{ds_id}"))
    rmtree(extract_dir)
    return h5_dir


def get_waenet_paths(path: Union[os.PathLike, str], dataset_id: int,
                     download: bool = False) -> List[str]:
    """Get paths to the WAE-NET volumes of one sub-dataset."""
    h5_dir = get_waenet_data(path, dataset_id, download)
    return util.natsorted(glob(os.path.join(h5_dir, "*.h5")))


def get_waenet_dataset(path: Union[os.PathLike, str], patch_shape, dataset_id: int = 1,
                       label_type: str = "nucleus", download: bool = False, **kwargs):
    """Get a WAE-NET dataset for one semantic class."""
    assert label_type in DATASET_CLASS_NAMES[dataset_id], \
        f"'{label_type}' is not a class of dataset {dataset_id}."
    paths = get_waenet_paths(path, dataset_id, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, f"labels/{label_type}",
                                        patch_shape, ndim=2, **kwargs)


def get_waenet_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                      dataset_id: int = 1, label_type: str = "nucleus",
                      download: bool = False, **kwargs) -> DataLoader:
    """Get a WAE-NET data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_waenet_dataset(path, patch_shape, dataset_id=dataset_id, label_type=label_type,
                            download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
