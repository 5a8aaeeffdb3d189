"""UWaterloo Skin dataset: skin lesion segmentation in dermatology photos
(reference torch_em/data/datasets/medical/uwaterloo_skin.py).

From https://uwaterloo.ca/vision-image-processing-lab/research-demos/skin-cancer-detection.
"""

import os
from glob import glob
from typing import List, Tuple, Union
from urllib.parse import urljoin

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

BASE_URL = ("https://uwaterloo.ca/vision-image-processing-lab/sites/"
            "ca.vision-image-processing-lab/files/uploads/files/")
ZIPFILES = {
    "set1": "skin_image_data_set-1.zip",  # patients with melanoma
    "set2": "skin_image_data_set-2.zip",  # patients without melanoma
}
CHECKSUMS = {
    "set1": "1788cd3eb7a4744012aad9a154e514fc5b82b9f3b19e31cc1b6ded5fc6bed297",
    "set2": "108a818baf20b36ef4544ebda10a8075dad99e335f0535c9533bb14cb02b5c53",
}


def get_uwaterloo_skin_data(path: Union[os.PathLike, str], chosen_set: str,
                            download: bool = False) -> str:
    """Download the UWaterloo Skin data for one subset ('set1' / 'set2')."""
    assert chosen_set in ZIPFILES, f"'{chosen_set}' is not a valid set."
    data_dir = os.path.join(path, f"{chosen_set}_Data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, ZIPFILES[chosen_set])
    url = urljoin(BASE_URL, ZIPFILES[chosen_set])
    util.download_source(zip_path, url, download, CHECKSUMS[chosen_set])
    util.unzip(zip_path, path)
    return data_dir


def get_uwaterloo_skin_paths(path: Union[os.PathLike, str], chosen_set: str = "set1",
                             download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the UWaterloo Skin images and lesion masks."""
    data_dir = get_uwaterloo_skin_data(path, chosen_set, download)
    image_paths = sorted(glob(os.path.join(data_dir, "skin_data", "melanoma", "*", "*_orig.jpg")))
    gt_paths = sorted(glob(os.path.join(data_dir, "skin_data", "melanoma", "*", "*_contour.png")))
    if not image_paths:
        image_paths = sorted(glob(os.path.join(data_dir, "skin_data", "*", "*", "*_orig.jpg")))
        gt_paths = sorted(glob(os.path.join(data_dir, "skin_data", "*", "*", "*_contour.png")))
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_uwaterloo_skin_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                               chosen_set: str = "set1", resize_inputs: bool = False,
                               download: bool = False, **kwargs):
    """Get the UWaterloo Skin dataset for lesion segmentation."""
    image_paths, gt_paths = get_uwaterloo_skin_paths(path, chosen_set, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_uwaterloo_skin_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                              batch_size: int, chosen_set: str = "set1",
                              resize_inputs: bool = False, download: bool = False,
                              **kwargs) -> DataLoader:
    """Get the UWaterloo Skin data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_uwaterloo_skin_dataset(path, patch_shape, chosen_set=chosen_set,
                                    resize_inputs=resize_inputs, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
