"""DynamicNuclearNet dataset: nucleus segmentation in fluorescence live-cell
imaging (reference
torch_em/data/datasets/light_microscopy/dynamicnuclearnet.py).

The data must be downloaded manually from https://datasets.deepcell.org/
(requires a free account); this module converts the published npz splits
into per-image zarr containers.
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import write_data
from .. import util


def _create_split(path, split):
    split_file = os.path.join(path, "DynamicNuclearNet-segmentation-v1_0", f"{split}.npz")
    split_folder = os.path.join(path, split)
    os.makedirs(split_folder, exist_ok=True)
    data = np.load(split_file, allow_pickle=True)
    x, y = data["X"], data["y"]
    for i, (im, label) in enumerate(zip(x, y)):
        out_path = os.path.join(split_folder, f"image_{i:04}.zarr")
        write_data(out_path, "raw", im[..., 0])
        write_data(out_path, "labels", label[..., 0])
    os.remove(split_file)


def get_dynamicnuclearnet_data(path: Union[os.PathLike, str], split: str,
                               download: bool = False) -> str:
    """Convert the manually downloaded DynamicNuclearNet data for a split."""
    splits = ("train", "val", "test")
    assert split in splits, f"Invalid split: {split}"
    split_folder = os.path.join(path, split)
    if os.path.exists(split_folder):
        return split_folder
    if download:
        raise NotImplementedError(
            "Automatic download is not possible for DynamicNuclearNet; download "
            "'DynamicNuclearNet-segmentation-v1_0' from https://datasets.deepcell.org/ "
            f"and place the zip at {path}."
        )
    zip_path = os.path.join(path, "DynamicNuclearNet-segmentation-v1_0.zip")
    if os.path.exists(zip_path):
        util.unzip(zip_path, path, remove=False)
    for _split in splits:
        if os.path.exists(os.path.join(path, "DynamicNuclearNet-segmentation-v1_0",
                                       f"{_split}.npz")):
            _create_split(path, _split)
    assert os.path.exists(split_folder), \
        f"Could not create the DynamicNuclearNet {split} split; check the files at {path}."
    return split_folder


def get_dynamicnuclearnet_paths(path: Union[os.PathLike, str], split: str,
                                download: bool = False) -> List[str]:
    """Get paths to the DynamicNuclearNet zarr images."""
    split_folder = get_dynamicnuclearnet_data(path, split, download)
    return util.natsorted(glob(os.path.join(split_folder, "*.zarr")))


def get_dynamicnuclearnet_dataset(path: Union[os.PathLike, str], split: str, patch_shape,
                                  download: bool = False, **kwargs):
    """Get the DynamicNuclearNet dataset for nucleus segmentation."""
    paths = get_dynamicnuclearnet_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape,
                                        ndim=2, **kwargs)


def get_dynamicnuclearnet_loader(path: Union[os.PathLike, str], split: str, patch_shape,
                                 batch_size: int, download: bool = False,
                                 **kwargs) -> DataLoader:
    """Get the DynamicNuclearNet data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_dynamicnuclearnet_dataset(path, split, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
