"""TissueNet dataset: cell and nucleus segmentation in multiplexed tissue
imaging (reference torch_em/data/datasets/light_microscopy/tissuenet.py).

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
    split_file = os.path.join(path, f"tissuenet_v1.1_{split}.npz")
    split_folder = os.path.join(path, split)
    os.makedirs(split_folder, exist_ok=True)
    data = np.load(split_file, allow_pickle=True)
    x, y = data["X"], data["y"]
    for i, (im, label) in enumerate(zip(x, y)):
        out_path = os.path.join(split_folder, f"image_{i:04}.zarr")
        nucleus_channel = im[..., 0]
        cell_channel = im[..., 1]
        rgb = np.stack([cell_channel, nucleus_channel, np.zeros_like(nucleus_channel)])
        write_data(out_path, "raw/nucleus", nucleus_channel)
        write_data(out_path, "raw/cell", cell_channel)
        write_data(out_path, "raw/rgb", rgb)
        # the 0<->1 switch is intentional (the published format is inconsistent)
        write_data(out_path, "labels/nucleus", label[..., 1])
        write_data(out_path, "labels/cell", label[..., 0])
    os.remove(split_file)


def get_tissuenet_data(path: Union[os.PathLike, str], split: str,
                       download: bool = False) -> str:
    """Convert the manually downloaded TissueNet data for a split."""
    splits = ("train", "val", "test")
    assert split in splits, f"Invalid split: {split}"
    split_folder = os.path.join(path, split)
    if os.path.exists(split_folder):
        return split_folder
    if download:
        raise NotImplementedError(
            "Automatic download is not possible for TissueNet; download "
            "'tissuenet_v1.1' from https://datasets.deepcell.org/ and place the zip at "
            f"{path}."
        )
    zip_path = os.path.join(path, "tissuenet_v1.1.zip")
    if os.path.exists(zip_path):
        util.unzip(zip_path, path, remove=False)
    for _split in splits:
        if os.path.exists(os.path.join(path, f"tissuenet_v1.1_{_split}.npz")):
            _create_split(path, _split)
    assert os.path.exists(split_folder), \
        f"Could not create the TissueNet {split} split; check the downloaded files at {path}."
    return split_folder


def get_tissuenet_paths(path: Union[os.PathLike, str], split: str,
                        download: bool = False) -> List[str]:
    """Get paths to the TissueNet zarr images for a split."""
    split_folder = get_tissuenet_data(path, split, download)
    return util.natsorted(glob(os.path.join(split_folder, "*.zarr")))


def get_tissuenet_dataset(path: Union[os.PathLike, str], split: str, patch_shape,
                          raw_channel: str = "cell", label_channel: str = "cell",
                          download: bool = False, **kwargs):
    """Get the TissueNet dataset (raw_channel: 'nucleus'/'cell'/'rgb';
    label_channel: 'nucleus'/'cell')."""
    assert raw_channel in ("nucleus", "cell", "rgb")
    assert label_channel in ("nucleus", "cell")
    paths = get_tissuenet_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(
        paths, f"raw/{raw_channel}", paths, f"labels/{label_channel}", patch_shape,
        ndim=2, with_channels=(raw_channel == "rgb"), **kwargs,
    )


def get_tissuenet_loader(path: Union[os.PathLike, str], split: str, patch_shape,
                         batch_size: int, raw_channel: str = "cell",
                         label_channel: str = "cell", download: bool = False,
                         **kwargs) -> DataLoader:
    """Get the TissueNet data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_tissuenet_dataset(path, split, patch_shape, raw_channel=raw_channel,
                               label_channel=label_channel, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
