"""BetaSeg dataset: organelle segmentation in beta-cell FIB-SEM volumes
(reference torch_em/data/datasets/electron_microscopy/betaseg.py).

See https://betaseg.github.io/; publication: https://arxiv.org/abs/2303.03876
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

URL = "https://cloud.mpi-cbg.de/index.php/s/UJopHTRuh6f4wR8/download"
CHECKSUM = "4872eec0211721dc224acee319c27c4f51c190adc36004e3d5bb60dfcd67eb7b"

LABEL_CHOICES = ("centriole", "golgi", "granules", "membrane", "mitochondria", "nucleus")


def get_betaseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and convert the BetaSeg data (per-volume h5 with all
    organelle label channels)."""
    h5py = _h5py()

    data_dir = os.path.join(path, "data")
    if glob(os.path.join(data_dir, "*.h5")):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "betaseg.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, data_dir)

    for vol_dir in glob(os.path.join(data_dir, "download", "*")):
        name = os.path.basename(vol_dir)
        raw_path = os.path.join(vol_dir, f"{name}_source.tif")
        if not os.path.exists(raw_path):
            continue
        label_paths = {
            "centriole": os.path.join(vol_dir, f"{name}_centrioles.tif"),
            "golgi": os.path.join(vol_dir, f"{name}_golgi_corrected.tif"),
            "granules": os.path.join(vol_dir, f"{name}_granules.tif"),
            "membrane": os.path.join(vol_dir, f"{name}_membrane_full_mask.tif"),
            "mitochondria": os.path.join(vol_dir, f"{name}_mitochondria.tif"),
            "nucleus": os.path.join(vol_dir, f"{name}_nucleus.tif"),
        }
        raw = np.asarray(load_image(raw_path))
        with h5py.File(os.path.join(data_dir, str(Path(name).with_suffix(".h5"))), "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            for key, lpath in label_paths.items():
                if os.path.exists(lpath):
                    f.create_dataset(f"labels/{key}", data=np.asarray(load_image(lpath)),
                                     compression="gzip")
    return data_dir


def get_betaseg_paths(path: Union[os.PathLike, str], download: bool = False) -> List[str]:
    """Get paths to the BetaSeg volumes."""
    data_dir = get_betaseg_data(path, download)
    return util.natsorted(glob(os.path.join(data_dir, "*.h5")))


def get_betaseg_dataset(path: Union[os.PathLike, str], patch_shape, label_choice: str,
                        download: bool = False, **kwargs):
    """Get the BetaSeg dataset for one organelle label choice."""
    assert label_choice in LABEL_CHOICES, \
        f"'{label_choice}' is not valid; choose from {LABEL_CHOICES}."
    paths = get_betaseg_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, f"labels/{label_choice}",
                                        patch_shape, **kwargs)


def get_betaseg_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                       label_choice: str, download: bool = False, **kwargs) -> DataLoader:
    """Get the BetaSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_betaseg_dataset(path, patch_shape, label_choice, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
