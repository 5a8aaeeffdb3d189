"""EmbedSeg training datasets: 3D nucleus / cell segmentation volumes from
the EmbedSeg publication (reference
torch_em/data/datasets/light_microscopy/embedseg_data.py).

Publication: https://proceedings.mlr.press/v143/lalit21a.html
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URLS = {
    "Mouse-Organoid-Cells-CBG":
        "https://github.com/juglab/EmbedSeg/releases/download/v0.1.0/Mouse-Organoid-Cells-CBG.zip",
    "Mouse-Skull-Nuclei-CBG":
        "https://github.com/juglab/EmbedSeg/releases/download/v0.1.0/Mouse-Skull-Nuclei-CBG.zip",
    "Platynereis-ISH-Nuclei-CBG":
        "https://github.com/juglab/EmbedSeg/releases/download/v0.1.0/Platynereis-ISH-Nuclei-CBG.zip",
    "Platynereis-Nuclei-CBG":
        "https://github.com/juglab/EmbedSeg/releases/download/v0.1.0/Platynereis-Nuclei-CBG.zip",
}
CHECKSUMS = {
    "Mouse-Organoid-Cells-CBG": "3695ac340473900ace8c37fd7f3ae0d37217de9f2b86c2341f36b1727825e48b",
    "Mouse-Skull-Nuclei-CBG": "3600ec261a48bf953820e0536cacd0bb8a5141be6e7435a4cb0fffeb0caf594e",
    "Platynereis-ISH-Nuclei-CBG": "bc9284df6f6d691a8e81b47310d95617252cc98ebf7daeab55801b330ba921e0",
    "Platynereis-Nuclei-CBG": "448cb7b46f2fe7d472795e05c8d7dfb40f259d94595ad2cfd256bc2aa4ab3be7",
}


def get_embedseg_data(path: Union[os.PathLike, str], name: str, download: bool = False) -> str:
    """Download one of the EmbedSeg datasets."""
    if name not in URLS:
        raise ValueError(f"The dataset name must be in {list(URLS.keys())}, got {name}.")
    data_root = os.path.join(path, name)
    if os.path.exists(data_root):
        return data_root
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, f"{name}.zip")
    util.download_source(zip_path, URLS[name], download, CHECKSUMS[name])
    util.unzip(zip_path, path)
    return data_root


def get_embedseg_paths(path: Union[os.PathLike, str], name: str, split: str = "train",
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the EmbedSeg images and masks."""
    data_root = get_embedseg_data(path, name, download)
    raw_paths = sorted(glob(os.path.join(data_root, split, "images", "*.tif")))
    label_paths = sorted(glob(os.path.join(data_root, split, "masks", "*.tif")))
    assert len(raw_paths) > 0 and len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_embedseg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                         name: str, split: str = "train", download: bool = False, **kwargs):
    """Get an EmbedSeg dataset for 3D instance segmentation."""
    raw_paths, label_paths = get_embedseg_paths(path, name, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_embedseg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                        batch_size: int, name: str, split: str = "train",
                        download: bool = False, **kwargs) -> DataLoader:
    """Get an EmbedSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_embedseg_dataset(path, patch_shape, name=name, split=split,
                              download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
