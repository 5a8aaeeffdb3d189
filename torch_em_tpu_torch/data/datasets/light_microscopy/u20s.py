"""U2OS dataset (BBBC039): nucleus segmentation in fluorescence images
(reference torch_em/data/datasets/light_microscopy/u20s.py).

From the Broad Bioimage Benchmark Collection,
https://bbbc.broadinstitute.org/BBBC039.
"""

import os
import shutil
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URLS = {
    "images": "https://data.broadinstitute.org/bbbc/BBBC039/images.zip",
    "masks": "https://data.broadinstitute.org/bbbc/BBBC039/masks.zip",
}
CHECKSUMS = {
    "images": "6f30a5d4fe38c928ded972704f085975f8dc0d65d9aa366df00e5a9d449fddd7",
    "masks": "f9e6043d8ca56344a4886f96a700d804d6ee982f31e2b2cd3194af2a053c2710",
}


def _process_masks(path):
    Image = _pil_image()

    from ....ops.host import connected_components

    label_dir = os.path.join(path, "labels")
    os.makedirs(label_dir)
    for p in glob(os.path.join(path, "masks", "*.png")):
        curr_mask = np.asarray(load_image(p))
        assert curr_mask.ndim == 3 and curr_mask.shape[-1] == 4
        curr_mask = connected_components(curr_mask[:, :, 0]).astype("int32")
        Image.fromarray(curr_mask, mode="I").save(
            os.path.join(label_dir, f"{Path(p).stem}.tif"))
    shutil.rmtree(os.path.join(path, "masks"))
    shutil.rmtree(os.path.join(path, "__MACOSX"), ignore_errors=True)


def get_u20s_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the U2OS (BBBC039) data."""
    label_dir = os.path.join(path, "labels")
    if os.path.exists(label_dir):
        return path
    os.makedirs(path, exist_ok=True)
    for name, url in URLS.items():
        zip_path = os.path.join(path, f"{name}.zip")
        util.download_source(zip_path, url, download, CHECKSUMS[name])
        util.unzip(zip_path, path)
    _process_masks(path)
    return path


def get_u20s_paths(path: Union[os.PathLike, str],
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the U2OS images and instance labels."""
    data_dir = get_u20s_data(path, download)
    image_paths = util.natsorted(glob(os.path.join(data_dir, "images", "*.tif")))
    label_paths = util.natsorted(glob(os.path.join(data_dir, "labels", "*.tif")))
    return image_paths, label_paths


def get_u20s_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     download: bool = False, **kwargs):
    """Get the U2OS dataset for nucleus segmentation."""
    image_paths, label_paths = get_u20s_paths(path, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(image_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_u20s_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                    batch_size: int, download: bool = False, **kwargs) -> DataLoader:
    """Get the U2OS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_u20s_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
