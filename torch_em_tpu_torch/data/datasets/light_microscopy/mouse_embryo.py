"""Mouse embryo dataset: membrane and nucleus segmentation in confocal
light microscopy (reference
torch_em/data/datasets/light_microscopy/mouse_embryo.py).

Publication: https://doi.org/10.15252/embj.2022113280
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/record/6546550/files/MouseEmbryos.zip?download=1"
CHECKSUM = "bf24df25e5f919489ce9e674876ff27e06af84445c48cf2900f1ab590a042622"


def get_mouse_embryo_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the mouse embryo data."""
    if os.path.exists(os.path.join(path, "Membrane")):
        return path
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "membrane.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    # one file is broken in the published zip
    broken = os.path.join(
        path, "Membrane", "train", "fused_paral_stack0_chan2_tp00073_raw_crop_bg_noise.h5"
    )
    if os.path.exists(broken):
        os.remove(broken)
    return path


def get_mouse_embryo_paths(path: Union[os.PathLike, str], name: str, split: str,
                           download: bool = False) -> List[str]:
    """Get paths to the mouse embryo volumes for a task ('membrane' /
    'nuclei') and split ('train' / 'val')."""
    get_mouse_embryo_data(path, download)
    # the nuclei data has a test instead of a val split
    split_ = "test" if name == "nuclei" and split == "val" else split
    paths = sorted(glob(os.path.join(path, name.capitalize(), split_, "*.h5")))
    assert len(paths) > 0, f"No volumes for {name}/{split}"
    return paths


def get_mouse_embryo_dataset(path: Union[os.PathLike, str], name: str, split: str,
                             patch_shape: Tuple[int, int, int],
                             offsets=None, boundaries: bool = False, binary: bool = False,
                             download: bool = False, **kwargs):
    """Get the mouse embryo dataset for membrane or nucleus segmentation."""
    assert name in ("membrane", "nuclei")
    assert split in ("train", "val")
    paths = get_mouse_embryo_paths(path, name, split, download)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=binary, binary=binary, boundaries=boundaries,
        offsets=offsets, binary_is_exclusive=False,
    )
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "label", patch_shape, **kwargs)


def get_mouse_embryo_loader(path: Union[os.PathLike, str], name: str, split: str,
                            patch_shape: Tuple[int, int, int], batch_size: int,
                            offsets=None, boundaries: bool = False, binary: bool = False,
                            download: bool = False, **kwargs) -> DataLoader:
    """Get the mouse embryo data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_mouse_embryo_dataset(
        path, name, split, patch_shape, offsets=offsets, boundaries=boundaries,
        binary=binary, download=download, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
