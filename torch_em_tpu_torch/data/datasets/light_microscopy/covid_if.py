"""Covid-IF immunofluorescence cell segmentation dataset (reference
torch_em/data/datasets/light_microscopy/covid_if.py).

Publication: https://doi.org/10.1002/bies.202000257
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

COVID_IF_URL = "https://zenodo.org/record/5092850/files/covid-if-groundtruth.zip?download=1"
CHECKSUM = "d9cd6c85a19b802c771fb4ff928894b19a8fab0e0af269c49235fdac3f7a60e1"


def get_covid_if_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the Covid-IF data."""
    url, checksum = COVID_IF_URL, CHECKSUM
    if os.path.exists(path):
        return path
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "covid-if.zip")
    util.download_source(zip_path, url, download, checksum)
    util.unzip(zip_path, path, True)
    return path


def get_covid_if_paths(path: Union[os.PathLike, str], sample_range: Optional[Tuple[int, int]] = None,
                       download: bool = False) -> List[str]:
    """Get paths to the Covid-IF files."""
    get_covid_if_data(path, download)
    file_names = sorted(glob(os.path.join(path, "*.h5")))
    if sample_range is not None:
        start, stop = sample_range
        if start is None:
            start = 0
        if stop is None:
            stop = len(file_names)
        file_names = [fn for i, fn in enumerate(file_names) if start <= i < stop]
        assert len(file_names) > 0, f"Invalid sample range {sample_range}"
    return file_names


def get_covid_if_dataset(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int],
    sample_range: Optional[Tuple[int, int]] = None,
    target: str = "cells",
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    **kwargs,
):
    """Get the Covid-IF dataset for cell or nucleus segmentation."""
    available_targets = ("cells", "nuclei")
    if target == "cells":
        raw_key, label_key = "raw/serum_IgG/s0", "labels/cells/s0"
    elif target == "nuclei":
        raw_key, label_key = "raw/nuclei/s0", "labels/nuclei/s0"
    else:
        raise ValueError(f"{target} not found in {available_targets}")

    file_paths = get_covid_if_paths(path, sample_range, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries, offsets=offsets,
    )
    kwargs = util.update_kwargs(kwargs, "ndim", 2)
    return default_segmentation_dataset(file_paths, raw_key, file_paths, label_key,
                                        patch_shape, **kwargs)


def get_covid_if_loader(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int],
    batch_size: int,
    sample_range: Optional[Tuple[int, int]] = None,
    target: str = "cells",
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    **kwargs,
) -> DataLoader:
    """Get the Covid-IF data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_covid_if_dataset(
        path, patch_shape, sample_range=sample_range, target=target, download=download,
        offsets=offsets, boundaries=boundaries, binary=binary, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
