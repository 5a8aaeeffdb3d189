"""PlantSeg plant-tissue segmentation datasets (reference
torch_em/data/datasets/light_microscopy/plantseg.py).

Confocal/lightsheet volumes of plant tissue (root, nuclei, ovules).
Publication: https://doi.org/10.7554/eLife.57613
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URLS = {
    "root": {
        "train": "https://files.de-1.osf.io/v1/resources/9x3g2/providers/osfstorage/?zip=",
        "val": "https://files.de-1.osf.io/v1/resources/vs6gb/providers/osfstorage/?zip=",
        "test": "https://files.de-1.osf.io/v1/resources/tn4xj/providers/osfstorage/?zip=",
    },
    "nuclei": {
        "train": "https://files.de-1.osf.io/v1/resources/thxzn/providers/osfstorage/?zip=",
    },
    "ovules": {
        "train": "https://files.de-1.osf.io/v1/resources/x9yns/providers/osfstorage/?zip=",
        "val": "https://files.de-1.osf.io/v1/resources/xp5uf/providers/osfstorage/?zip=",
        "test": "https://files.de-1.osf.io/v1/resources/8jz7e/providers/osfstorage/?zip=",
    },
}
# the checksums are not reliable for the osf zip downloads (see reference :37)
CHECKSUMS = {
    "root": {"train": None, "val": None, "test": None},
    "nuclei": {"train": None},
    "ovules": {"train": None, "val": None, "test": None},
}


def get_plantseg_data(path: Union[os.PathLike, str], name: str, split: str,
                      download: bool = False) -> str:
    """Download the PlantSeg data."""
    url = URLS[name][split]
    checksum = CHECKSUMS[name][split]
    os.makedirs(path, exist_ok=True)
    out_path = os.path.join(path, f"{name}_{split}")
    if os.path.exists(out_path):
        return out_path
    tmp_path = os.path.join(path, f"{name}_{split}.zip")
    util.download_source(tmp_path, url, download, checksum)
    util.unzip(tmp_path, out_path, remove=True)
    return out_path


def get_plantseg_paths(path: Union[os.PathLike, str], name: str, split: str,
                       download: bool = False) -> List[str]:
    """Get paths to the PlantSeg volumes."""
    data_path = get_plantseg_data(path, name, split, download)
    file_paths = sorted(glob(os.path.join(data_path, "*.h5")))
    assert len(file_paths) > 0, data_path
    return file_paths


def get_plantseg_dataset(
    path: Union[os.PathLike, str],
    name: str,
    split: str,
    patch_shape: Tuple[int, int, int],
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    **kwargs,
):
    """Get the PlantSeg dataset for tissue segmentation."""
    assert len(patch_shape) == 3
    file_paths = get_plantseg_paths(path, name, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=binary, binary=binary, boundaries=boundaries, offsets=offsets,
        binary_is_exclusive=False,
    )
    raw_key, label_key = "raw", "label"
    return default_segmentation_dataset(file_paths, raw_key, file_paths, label_key,
                                        patch_shape, **kwargs)


def get_plantseg_loader(
    path: Union[os.PathLike, str],
    name: str,
    split: str,
    patch_shape: Tuple[int, int, int],
    batch_size: int,
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    **kwargs,
) -> DataLoader:
    """Get the PlantSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_plantseg_dataset(
        path, name, split, patch_shape, download=download, offsets=offsets,
        boundaries=boundaries, binary=binary, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
