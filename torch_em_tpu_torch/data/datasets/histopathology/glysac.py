"""GLySAC dataset: nucleus segmentation & classification in gastric H&E
(reference torch_em/data/datasets/histopathology/glysac.py).

Google-drive hosted; publication: https://doi.org/10.1016/j.media.2021.102238
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

GDRIVE_ID = "1g1_xYFWgp3cRLKrlSwD2U5JDjooC0yHp"
URL = f"https://drive.google.com/uc?id={GDRIVE_ID}"


def _create_h5_files(data_dir, split):
    h5py = _h5py()
    from scipy.io import loadmat

    folder = "Train" if split == "train" else "Test"
    image_dir = os.path.join(data_dir, folder, "Images")
    label_dir = os.path.join(data_dir, folder, "Labels")
    h5_dir = os.path.join(data_dir, "h5", split)
    os.makedirs(h5_dir, exist_ok=True)
    for image_path in util.natsorted(glob(os.path.join(image_dir, "*.png"))):
        fname = os.path.splitext(os.path.basename(image_path))[0]
        h5_path = os.path.join(h5_dir, f"{fname}.h5")
        if os.path.exists(h5_path):
            continue
        raw = np.asarray(load_image(image_path))[..., :3]
        mat = loadmat(os.path.join(label_dir, f"{fname}.mat"))
        with h5py.File(h5_path, "w") as f:
            f.create_dataset("raw", data=raw.transpose(2, 0, 1), compression="gzip")
            f.create_dataset("labels/instances", data=mat["inst_map"].astype("int32"),
                             compression="gzip")
            f.create_dataset("labels/semantic", data=mat["type_map"].astype("int32"),
                             compression="gzip")


def get_glysac_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the GLySAC data (google drive)."""
    data_dir = os.path.join(path, "glysac_dataset")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "glysac.zip")
    util.download_source_gdrive(zip_path, URL, download, checksum=None)
    util.unzip(zip_path, path)
    return data_dir


def get_glysac_paths(path: Union[os.PathLike, str], split: str,
                     download: bool = False) -> List[str]:
    """Get paths to the GLySAC volumes for a split ('train' / 'test')."""
    assert split in ("train", "test"), f"Invalid split: {split}"
    data_dir = get_glysac_data(path, download)
    h5_dir = os.path.join(data_dir, "h5", split)
    if not os.path.exists(h5_dir) or not glob(os.path.join(h5_dir, "*.h5")):
        _create_h5_files(data_dir, split)
    return util.natsorted(glob(os.path.join(h5_dir, "*.h5")))


def get_glysac_dataset(path: Union[os.PathLike, str], patch_shape, split: str,
                       label_choice: str = "instances", download: bool = False, **kwargs):
    """Get the GLySAC dataset for nucleus segmentation."""
    paths = get_glysac_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, f"labels/{label_choice}",
                                        patch_shape, ndim=2, with_channels=True, **kwargs)


def get_glysac_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                      split: str, label_choice: str = "instances",
                      download: bool = False, **kwargs) -> DataLoader:
    """Get the GLySAC data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_glysac_dataset(path, patch_shape, split, label_choice=label_choice,
                            download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
