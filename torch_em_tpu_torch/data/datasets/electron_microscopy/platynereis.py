"""Platynereis EM datasets: cells, nuclei, cilia, cuticle (reference
torch_em/data/datasets/electron_microscopy/platynereis.py).

Publication: https://doi.org/10.1016/j.cell.2021.07.017
"""

import os
from glob import glob
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URLS = {
    "cells": "https://zenodo.org/record/3675220/files/membrane.zip",
    "nuclei": "https://zenodo.org/record/3675220/files/nuclei.zip",
    "cilia": "https://zenodo.org/record/3675220/files/cilia.zip",
    "cuticle": "https://zenodo.org/record/3675220/files/cuticle.zip",
}
CHECKSUMS = {
    "cells": "30eb50c39e7e9883e1cd96e0df689fac37a56abb11e8ed088907c94a5980d6a3",
    "nuclei": "a05033c5fbc6a3069479ac6595b0a430070f83f5281f5b5c8913125743cf5510",
    "cilia": "6d2b47f63d39a671789c02d8b66cad5e4cf30eb14cdb073da1a52b7defcc5e24",
    "cuticle": "464f75d30133e8864958049647fe3c2216ddf2d4327569738ad72d299c991843",
}
FILE_TEMPLATES = {
    "cells": "train_data_membrane_%02i.n5",
    "nuclei": "train_data_nuclei_%02i.h5",
    "cilia": "train_data_cilia_%02i.h5",
    "cuticle": "train_data_%02i.n5",
}


def get_platynereis_data(path: Union[os.PathLike, str], name: str, download: bool) -> Tuple[str, int]:
    """Download the platynereis data for a given task."""
    data_root = os.path.join(path, name)
    if name == "cuticle":
        ext, prefix, n_files = ".n5", "train_data_", 5
    elif name == "cilia":
        ext, prefix, n_files = ".h5", "train_data_cilia_", 3
    elif name == "cells":
        data_root = os.path.join(path, "membrane")
        ext, prefix, n_files = ".n5", "train_data_membrane_", 9
    elif name == "nuclei":
        ext, prefix, n_files = ".h5", "train_data_nuclei_", 12
    else:
        raise ValueError(f"Invalid name {name}. Expect one of 'cuticle', 'cilia', 'cells' or 'nuclei'.")

    if os.path.exists(data_root) and len(glob(os.path.join(data_root, f"{prefix}*{ext}"))) == n_files:
        return data_root, n_files
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, f"data-{name}.zip")
    util.download_source(zip_path, URLS[name], download=download, checksum=CHECKSUMS[name])
    util.unzip(zip_path, path, remove=True)
    return data_root, n_files


def get_platynereis_paths(path, sample_ids, name, download=False) -> List[str]:
    """Get paths to the platynereis volumes."""
    data_root, n_files = get_platynereis_data(path, name, download)
    template = os.path.join(data_root, FILE_TEMPLATES[name])
    if sample_ids is None:
        sample_ids = list(range(1, n_files + 1))
    paths = [template % sample for sample in sample_ids]
    return paths


_TASK_KEYS = {
    "cells": ("volumes/raw/s1", "volumes/labels/segmentation/s1"),
    "nuclei": ("volumes/raw", "volumes/labels/nucleus_instance_labels"),
    "cilia": ("volumes/raw", "volumes/labels/segmentation"),
    "cuticle": ("volumes/raw/s1", "volumes/labels/segmentation/s1"),
}


def get_platynereis_dataset(
    path: Union[os.PathLike, str],
    name: str,
    patch_shape: Tuple[int, int, int],
    sample_ids: Optional[Sequence[int]] = None,
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    **kwargs,
):
    """Get a platynereis dataset for the given segmentation task."""
    paths = get_platynereis_paths(path, sample_ids, name, download)
    raw_key, label_key = _TASK_KEYS[name]
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(paths, raw_key, paths, label_key, patch_shape, **kwargs)


def get_platynereis_loader(
    path: Union[os.PathLike, str],
    name: str,
    patch_shape: Tuple[int, int, int],
    batch_size: int,
    sample_ids: Optional[Sequence[int]] = None,
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    **kwargs,
) -> DataLoader:
    """Get a platynereis data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_platynereis_dataset(
        path, name, patch_shape, sample_ids=sample_ids, download=download,
        offsets=offsets, boundaries=boundaries, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)


# task-specific convenience wrappers (reference exposes per-task functions)
def get_platynereis_cell_dataset(path, patch_shape, sample_ids=None, **kwargs):
    return get_platynereis_dataset(path, "cells", patch_shape, sample_ids, **kwargs)


def get_platynereis_cell_loader(path, patch_shape, batch_size, sample_ids=None, **kwargs):
    return get_platynereis_loader(path, "cells", patch_shape, batch_size, sample_ids, **kwargs)


def get_platynereis_nuclei_dataset(path, patch_shape, sample_ids=None, **kwargs):
    return get_platynereis_dataset(path, "nuclei", patch_shape, sample_ids, **kwargs)


def get_platynereis_nuclei_loader(path, patch_shape, batch_size, sample_ids=None, **kwargs):
    return get_platynereis_loader(path, "nuclei", patch_shape, batch_size, sample_ids, **kwargs)


def get_platynereis_cilia_dataset(path, patch_shape, sample_ids=None, **kwargs):
    return get_platynereis_dataset(path, "cilia", patch_shape, sample_ids, **kwargs)


def get_platynereis_cilia_loader(path, patch_shape, batch_size, sample_ids=None, **kwargs):
    return get_platynereis_loader(path, "cilia", patch_shape, batch_size, sample_ids, **kwargs)
