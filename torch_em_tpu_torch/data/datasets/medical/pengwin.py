"""PENGWIN dataset: pelvic fracture fragment segmentation in CT and X-Ray
(reference torch_em/data/datasets/medical/pengwin.py).

Challenge: https://pengwin.grand-challenge.org/pengwin/;
publication: https://doi.org/10.1007/978-3-031-43996-4_30
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URLS = {
    "CT": [
        "https://zenodo.org/records/10927452/files/PENGWIN_CT_train_images_part1.zip",
        "https://zenodo.org/records/10927452/files/PENGWIN_CT_train_images_part2.zip",
        "https://zenodo.org/records/10927452/files/PENGWIN_CT_train_labels.zip",
    ],
    "X-Ray": ["https://zenodo.org/records/10913196/files/train.zip"],
}
CHECKSUMS = {
    "CT": [
        "e2e9f99798960607ffced1fbdeee75a626c41bf859eaf4125029a38fac6b7609",
        "19f3cdc5edd1daf9324c70f8ba683eed054f6ed8f2b1cc59dbd80724f8f0bbb2",
        "c4d3857e02d3ee5d0df6c8c918dd3cf5a7c9419135f1ec089b78215f37c6665c",
    ],
    "X-Ray": ["48d107979eb929a3c61da4e75566306a066408954cf132907bda570f2a7de725"],
}
TARGET_DIRS = {"CT": ["CT/images", "CT/images", "CT/labels"], "X-Ray": ["X-Ray"]}
MODALITIES = ("CT", "X-Ray")


def get_pengwin_data(path: Union[os.PathLike, str], modality: str,
                     download: bool = False) -> str:
    """Download the PENGWIN data for a modality ('CT' / 'X-Ray')."""
    if modality not in MODALITIES:
        raise ValueError(f"'{modality}' is not a valid modality; choose from {MODALITIES}.")
    data_dir = os.path.join(path, "data")
    if os.path.exists(os.path.join(data_dir, modality)):
        return data_dir
    os.makedirs(path, exist_ok=True)
    for url, checksum, dst_dir in zip(URLS[modality], CHECKSUMS[modality], TARGET_DIRS[modality]):
        zip_path = os.path.join(path, os.path.split(url)[-1])
        util.download_source(zip_path, url, download, checksum)
        util.unzip(zip_path, os.path.join(data_dir, dst_dir))
    return data_dir


def get_pengwin_paths(path: Union[os.PathLike, str], modality: str,
                      download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the PENGWIN images and fragment labels."""
    data_dir = get_pengwin_data(path, modality, download)
    if modality == "CT":
        image_paths = util.natsorted(glob(os.path.join(data_dir, modality, "images", "*.mha")))
        gt_paths = util.natsorted(glob(os.path.join(data_dir, modality, "labels", "*.mha")))
    else:
        base_dir = os.path.join(data_dir, modality, "train")
        image_paths = util.natsorted(glob(os.path.join(base_dir, "input", "images", "*.tif")))
        gt_paths = util.natsorted(glob(os.path.join(base_dir, "output", "images", "*.tif")))
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_pengwin_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                        modality: str, resize_inputs: bool = False,
                        download: bool = False, **kwargs):
    """Get the PENGWIN dataset for fracture segmentation."""
    image_paths, gt_paths = get_pengwin_paths(path, modality, download)
    ndim = 3 if modality == "CT" else 2
    kwargs = util.ensure_transforms(ndim=ndim, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    if modality == "CT":
        return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                            **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_pengwin_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                       batch_size: int, modality: str, resize_inputs: bool = False,
                       download: bool = False, **kwargs) -> DataLoader:
    """Get the PENGWIN data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_pengwin_dataset(path, patch_shape, modality, resize_inputs=resize_inputs,
                             download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
