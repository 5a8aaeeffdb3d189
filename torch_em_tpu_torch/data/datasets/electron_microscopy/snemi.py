"""SNEMI neuron segmentation dataset in EM (reference
torch_em/data/datasets/electron_microscopy/snemi.py).

Publication: https://doi.org/10.1016/j.cell.2015.06.054
"""

import os
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

SNEMI_URLS = {
    "train": "https://oc.embl.de/index.php/s/43iMotlXPyAB39z/download",
    "test": "https://oc.embl.de/index.php/s/aRhphk35H23De2s/download",
}
CHECKSUMS = {
    "train": "5b130a24d9eb23d972fede0f1a403bc05f6808b361cfa22eff23b930b12f0615",
    "test": "3df3920a0ddec6897105845f842b2665d37a47c2d1b96d4f4565682e315a59fa",
}


def get_snemi_data(path: Union[os.PathLike, str], sample: str, download: bool = False) -> None:
    """Download the SNEMI training data."""
    os.makedirs(path, exist_ok=True)
    data_path = os.path.join(path, f"snemi_{sample}.h5")
    util.download_source(data_path, SNEMI_URLS[sample], download, CHECKSUMS[sample])


def get_snemi_paths(path: Union[os.PathLike, str], sample: str, download: bool = False) -> str:
    """Get the path to the SNEMI data."""
    get_snemi_data(path, sample, download)
    data_path = os.path.join(path, f"snemi_{sample}.h5")
    assert os.path.exists(data_path), data_path
    return data_path


def get_snemi_dataset(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int, int],
    sample: str = "train",
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    **kwargs,
):
    """Get the SNEMI dataset for neuron segmentation (affinity or boundary targets)."""
    data_path = get_snemi_paths(path, sample, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets,
    )
    raw_key = "volumes/raw"
    label_key = "volumes/labels/neuron_ids"
    return default_segmentation_dataset(data_path, raw_key, data_path, label_key,
                                        patch_shape, **kwargs)


def get_snemi_loader(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int, int],
    batch_size: int,
    sample: str = "train",
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    **kwargs,
) -> DataLoader:
    """Get the SNEMI data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_snemi_dataset(
        path=path, patch_shape=patch_shape, sample=sample, download=download,
        offsets=offsets, boundaries=boundaries, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
