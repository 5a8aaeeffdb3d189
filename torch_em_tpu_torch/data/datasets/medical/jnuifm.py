"""JNU-IFM dataset: pubic symphysis and fetal head segmentation in
intrapartum ultrasound (reference torch_em/data/datasets/medical/jnuifm.py).

Located at https://zenodo.org/records/7851339.
"""

import os
from glob import glob
from typing import List, Tuple, Union
from urllib.parse import urljoin

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

BASE_URL = "https://zenodo.org/records/7851339/files/"
URL = urljoin(BASE_URL, "Pubic%20Symphysis-Fetal%20Head%20Segmentation%20and%20Angle%20of%20Progression.zip")
CHECKSUM = "2b14d1c78e11cfb799d74951b0b985b90777c195f7a456ccd00528bf02802e21"


def get_jnuifm_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the JNU-IFM data."""
    data_dir = os.path.join(path, "Pubic Symphysis-Fetal Head Segmentation and Angle of Progression")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "JNU-IFM.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return data_dir


def get_jnuifm_paths(path: Union[os.PathLike, str],
                     download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the JNU-IFM images and labels (.mha)."""
    data_dir = get_jnuifm_data(path, download)
    image_paths = util.natsorted(glob(os.path.join(data_dir, "image_mha", "*.mha")))
    gt_paths = util.natsorted(glob(os.path.join(data_dir, "label_mha", "*.mha")))
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_jnuifm_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                       resize_inputs: bool = False, download: bool = False, **kwargs):
    """Get the JNU-IFM dataset for pubic symphysis / fetal head segmentation."""
    image_paths, gt_paths = get_jnuifm_paths(path, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_jnuifm_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                      batch_size: int, resize_inputs: bool = False,
                      download: bool = False, **kwargs) -> DataLoader:
    """Get the JNU-IFM data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_jnuifm_dataset(path, patch_shape, resize_inputs=resize_inputs,
                            download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
