"""ISBI 2012 neuron segmentation challenge dataset (reference
torch_em/data/datasets/electron_microscopy/isbi2012.py).

Publication: https://doi.org/10.3389/fnana.2015.00142
"""

import os
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

ISBI_URL = "https://oc.embl.de/index.php/s/h0TkwqxU0PJDdMd/download"
CHECKSUM = "0e10fe909a1243084d91773470856993b7d40126a12e85f0f1345a7a9e512f29"


def get_isbi_data(path: Union[os.PathLike, str], download: bool = False) -> None:
    """Download the ISBI 2012 data."""
    os.makedirs(path, exist_ok=True)
    util.download_source(os.path.join(path, "isbi.h5"), ISBI_URL, download, CHECKSUM)


def get_isbi_paths(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Get the path to the ISBI data."""
    get_isbi_data(path, download)
    return os.path.join(path, "isbi.h5")


def get_isbi_dataset(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int, int],
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    use_original_labels: bool = False,
    **kwargs,
):
    """Get the ISBI dataset for neuron segmentation."""
    assert len(patch_shape) == 3
    data_path = get_isbi_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets,
    )
    label_key = "labels/membranes" if use_original_labels else "labels/gt_segmentation"
    return default_segmentation_dataset(data_path, "raw", data_path, label_key,
                                        patch_shape, **kwargs)


def get_isbi_loader(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int, int],
    batch_size: int,
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    use_original_labels: bool = False,
    **kwargs,
) -> DataLoader:
    """Get the ISBI data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_isbi_dataset(
        path, patch_shape, download=download, offsets=offsets, boundaries=boundaries,
        use_original_labels=use_original_labels, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
