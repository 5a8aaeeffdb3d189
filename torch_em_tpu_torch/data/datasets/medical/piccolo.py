"""PICCOLO dataset: polyp segmentation in NBI/WL colonoscopy
(reference torch_em/data/datasets/medical/piccolo.py).

Access must be requested from the Basque Biobank (see get_piccolo_data).
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util


def get_piccolo_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Unpack the manually obtained PICCOLO rar archive.

    Access: visit the Basque Biobank PICCOLO page, fill the access request
    form (https://labur.eus/EzJUN) and request access by email; unpack the
    provided rar file at ``path``."""
    data_dir = os.path.join(path, "piccolo dataset-release0.1")
    if os.path.exists(data_dir):
        return data_dir
    if download:
        raise NotImplementedError(
            "Automatic download is not possible for PICCOLO; see 'get_piccolo_data'.")
    rar_file = os.path.join(path, "piccolo dataset_widefield-release0.1.rar")
    if not os.path.exists(rar_file):
        raise FileNotFoundError(
            "Download the PICCOLO dataset from the Basque Biobank; see 'get_piccolo_data'.")
    util.unzip_rarfile(rar_file, path, remove=False)
    return data_dir


def get_piccolo_paths(path: Union[os.PathLike, str], split: str,
                      download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the PICCOLO frames and polyp masks
    (split 'train' / 'validation' / 'test')."""
    data_dir = get_piccolo_data(path, download)
    image_paths = util.natsorted(glob(os.path.join(data_dir, split, "polyps", "*")))
    gt_paths = util.natsorted(glob(os.path.join(data_dir, split, "masks", "*")))
    return image_paths, gt_paths


def get_piccolo_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        split: str, resize_inputs: bool = False,
                        download: bool = False, **kwargs):
    """Get the PICCOLO dataset for polyp segmentation."""
    image_paths, gt_paths = get_piccolo_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_piccolo_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                       batch_size: int, split: str, resize_inputs: bool = False,
                       download: bool = False, **kwargs) -> DataLoader:
    """Get the PICCOLO data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_piccolo_dataset(path, patch_shape, split, resize_inputs=resize_inputs,
                             download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
