"""SegPC dataset: multiple myeloma plasma cell (and nuclei) segmentation in
microscopic images (reference
torch_em/data/datasets/light_microscopy/segpc.py).

The data must be downloaded manually from
https://ieee-dataport.org/open-access/segpc-2021-segmentation-multiple-myeloma-plasma-cells-microscopic-images,
placing 'TCIA_SegPC_dataset.zip' at ``path``. Inputs are preprocessed into
per-image h5 volumes with 'raw' (CHW) and 'labels/{nuclei,cells}'.
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util


def get_segpc_data(path: Union[os.PathLike, str], split: str,
                   download: bool = False) -> str:
    """Unpack the manually downloaded SegPC zip for 'train' or 'validation'."""
    if split not in ("train", "validation"):
        if split == "test":
            raise ValueError("The 'test' split does not have labels.")
        raise ValueError(f"'{split}' is not a valid split.")
    data_dir = os.path.join(path, "TCIA_SegPC_dataset", split)
    if os.path.exists(data_dir):
        return data_dir
    if download:
        raise NotImplementedError(
            "Automatic download is not supported; fetch 'TCIA_SegPC_dataset.zip' manually "
            "from ieee-dataport and place it at the path.")
    zip_path = os.path.join(path, "TCIA_SegPC_dataset.zip")
    if not os.path.exists(zip_path):
        raise FileNotFoundError(f"Could not find '{zip_path}'.")
    util.unzip(zip_path, path, remove=False)
    util.unzip(os.path.join(Path(data_dir).parent, f"{split}.zip"), Path(data_dir).parent)
    return data_dir


def get_segpc_paths(path: Union[os.PathLike, str], split: str,
                    download: bool = False) -> List[str]:
    """Preprocess the SegPC images into h5 volumes and return their paths."""
    h5py = _h5py()

    data_dir = get_segpc_data(path, split, download)
    preprocessed_dir = os.path.join(data_dir, "preprocessed")
    os.makedirs(preprocessed_dir, exist_ok=True)

    volume_paths = []
    raw_paths = util.natsorted(glob(os.path.join(data_dir, "x", "*.bmp")))
    for rpath in raw_paths:
        volume_path = os.path.join(
            preprocessed_dir, str(Path(os.path.basename(rpath)).with_suffix(".h5")))
        volume_paths.append(volume_path)
        if os.path.exists(volume_path):
            continue
        image = np.asarray(load_image(rpath))
        label_paths = glob(rpath.replace("x", "y").replace(".bmp", "_*.bmp"))
        nuclei = np.zeros(image.shape[:2], dtype="uint32")
        cells = np.zeros(image.shape[:2], dtype="uint32")
        for i, lpath in enumerate(label_paths, start=1):
            label = np.asarray(load_image(lpath))
            if label.ndim == 3:
                label = label[..., 0]
            # 40 marks the nucleus region, any positive value the whole cell
            nuclei[label == 40] = i
            cells[label > 0] = i
        with h5py.File(volume_path, "w") as f:
            f.create_dataset("raw", data=image.transpose(2, 0, 1), compression="gzip")
            f.create_dataset("labels/nuclei", data=nuclei, compression="gzip")
            f.create_dataset("labels/cells", data=cells, compression="gzip")
    return volume_paths


def get_segpc_dataset(path: Union[os.PathLike, str], patch_shape, split: str,
                      label_choice: str = "cells", download: bool = False, **kwargs):
    """Get the SegPC dataset for plasma cell (or nuclei) segmentation."""
    volume_paths = get_segpc_paths(path, split, download)
    return default_segmentation_dataset(
        volume_paths, "raw", volume_paths, f"labels/{label_choice}", patch_shape,
        with_channels=True, is_seg_dataset=True, ndim=2, **kwargs,
    )


def get_segpc_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                     split: str, label_choice: str = "cells",
                     download: bool = False, **kwargs) -> DataLoader:
    """Get the SegPC data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_segpc_dataset(path, patch_shape, split, label_choice=label_choice,
                           download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
