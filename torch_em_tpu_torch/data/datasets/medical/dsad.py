"""DSAD dataset: abdominal organ segmentation in laparoscopy (Dresden
Surgical Anatomy Dataset) (reference
torch_em/data/datasets/medical/dsad.py).

Located at https://springernature.figshare.com/ndownloader/files/38494425.
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://springernature.figshare.com/ndownloader/files/38494425"
CHECKSUM = "b8a8ade37d106fc1641a901d1c843806f2d27f9f8e18f4614b043e7e2ca2e40f"

ORGANS = [
    "abdominal_wall", "inferior_mesenteric_artery", "liver", "pancreas", "spleen", "ureter",
    "colon", "intestinal_veins", "multilabel", "small_intestine", "stomach", "vesicular_glands",
]


def get_dsad_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the DSAD data."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "data.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, data_dir, remove=False)
    return data_dir


def get_dsad_paths(path: Union[os.PathLike, str], organ: Optional[str] = None,
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the DSAD frames and organ masks."""
    data_dir = get_dsad_data(path, download)
    if organ is None:
        organ = "*"
    else:
        assert organ in ORGANS, f"'{organ}' is not a valid organ choice."
    image_paths = util.natsorted(glob(os.path.join(data_dir, organ, "*", "image*.png")))
    image_paths = [p for p in image_paths if "multilabel" not in p]
    mask_paths = [p.replace("image", "mask") for p in image_paths]
    assert all(os.path.exists(p) for p in mask_paths)
    assert image_paths and len(image_paths) == len(mask_paths)
    return image_paths, mask_paths


def get_dsad_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     organ: Optional[str] = None, resize_inputs: bool = False,
                     download: bool = False, **kwargs):
    """Get the DSAD dataset for organ segmentation."""
    image_paths, mask_paths = get_dsad_paths(path, organ, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, mask_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_dsad_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                    batch_size: int, organ: Optional[str] = None,
                    resize_inputs: bool = False, download: bool = False,
                    **kwargs) -> DataLoader:
    """Get the DSAD data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_dsad_dataset(path, patch_shape, organ=organ, resize_inputs=resize_inputs,
                          download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
