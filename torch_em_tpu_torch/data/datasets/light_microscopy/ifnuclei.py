"""IFNuclei dataset: nucleus segmentation in immunofluorescence images
(reference torch_em/data/datasets/light_microscopy/ifnuclei.py).

Publication: https://doi.org/10.1038/s41597-020-00608-w
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://www.ebi.ac.uk/biostudies/files/S-BSST265/dataset.zip"
CHECKSUM = "8285987ed4d57c46a46a55a33c1c085875ea41f429b59cde31d249741aa07ad1"


def get_ifnuclei_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the IFNuclei data."""
    if os.path.exists(os.path.join(path, "rawimages")):
        return path
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "dataset.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return path


def get_ifnuclei_paths(path: Union[os.PathLike, str],
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the IFNuclei images and instance labels."""
    get_ifnuclei_data(path, download)
    raw_paths = sorted(glob(os.path.join(path, "rawimages", "*.tif")))
    label_paths = sorted(glob(os.path.join(path, "groundtruth", "*")))
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_ifnuclei_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         offsets=None, boundaries: bool = False, binary: bool = False,
                         download: bool = False, **kwargs):
    """Get the IFNuclei dataset for nucleus segmentation."""
    raw_paths, label_paths = get_ifnuclei_paths(path, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_ifnuclei_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        batch_size: int, offsets=None, boundaries: bool = False,
                        binary: bool = False, download: bool = False, **kwargs) -> DataLoader:
    """Get the IFNuclei data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_ifnuclei_dataset(path, patch_shape, offsets=offsets, boundaries=boundaries,
                              binary=binary, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
