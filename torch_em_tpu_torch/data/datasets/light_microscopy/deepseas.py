"""DeepSeas dataset: cell segmentation in phase-contrast microscopy of stem
cells, bronchial cells and muscle cells
(reference torch_em/data/datasets/light_microscopy/deepseas.py).

The data must be downloaded manually (google drive folder, see URL);
project page: https://deepseas.org/datasets/.
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://drive.google.com/drive/folders/18odgkzafW8stHkzME_s7Es-ue7odVAc5?usp=sharing"


def get_deepseas_data(path: Union[os.PathLike, str], split: str,
                      download: bool = False) -> str:
    """Unpack the manually downloaded DeepSeas data for a split."""
    if split not in ("train", "test"):
        raise ValueError(f"'{split}' is not a valid split choice.")
    data_dir = os.path.join(path, "segmentation_dataset", split)
    if os.path.exists(data_dir):
        return data_dir
    zip_paths = glob(os.path.join(path, "*.zip"))
    if len(zip_paths) == 0 or download:
        raise NotImplementedError(
            "Automatic download for DeepSeas data is not supported. "
            f"Please download the 'segmentation_dataset' from {URL} and place the zips at {path}."
        )
    for zip_path in zip_paths:
        util.unzip(zip_path, path, remove=False)
    return data_dir


def get_deepseas_paths(path: Union[os.PathLike, str], split: str,
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the DeepSeas images and masks."""
    data_dir = get_deepseas_data(path, split, download)
    raw_paths = util.natsorted(glob(os.path.join(data_dir, "images", "*.png")))
    label_paths = util.natsorted(glob(os.path.join(data_dir, "masks", "*.png")))
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_deepseas_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         split: str, download: bool = False, **kwargs):
    """Get the DeepSeas dataset for cell segmentation."""
    raw_paths, label_paths = get_deepseas_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_deepseas_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        batch_size: int, split: str, download: bool = False,
                        **kwargs) -> DataLoader:
    """Get the DeepSeas data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_deepseas_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
