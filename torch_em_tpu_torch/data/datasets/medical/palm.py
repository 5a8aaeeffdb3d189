"""PALM dataset: optic disc and lesion segmentation in fundus images of
pathologic myopia (reference torch_em/data/datasets/medical/palm.py).

Located at https://springernature.figshare.com/ndownloader/files/37786152.
"""

import os
import shutil
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = "https://springernature.figshare.com/ndownloader/files/37786152"
CHECKSUM = "21cd568a00a50287370572ea81b50847085819bd2f732331ee9cdc6367e6cd1f"


def get_palm_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the PALM data."""
    data_dir = os.path.join(path, "PALM")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "data.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    shutil.rmtree(os.path.join(path, "__MACOSX"), ignore_errors=True)
    return data_dir


def _preprocess_labels(label_paths):
    """The published bmp masks mark the structure with 0; convert to binary
    foreground-1 tifs."""
    Image = _pil_image()

    neu_label_paths = [p.replace(".bmp", "_preprocessed.tif") for p in label_paths]
    for lpath, neu_lpath in zip(label_paths, neu_label_paths):
        if os.path.exists(neu_lpath):
            continue
        label = np.asarray(load_image(lpath))
        Image.fromarray((label == 0).astype("uint8")).save(neu_lpath)
    return neu_label_paths


def get_palm_paths(path: Union[os.PathLike, str], split: str,
                   label_choice: str = "disc",
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the PALM images and masks (split 'Training' /
    'Validation' / 'Testing'; label_choice 'disc' / 'atrophy_lesion' /
    'detachment_lesion')."""
    data_dir = get_palm_data(path, download)
    assert split in ("Training", "Validation", "Testing"), f"'{split}' is not a valid split."
    if label_choice == "disc":
        ldir = "Disc Masks"
    elif label_choice == "atrophy_lesion":
        ldir = "Lesion Masks/Atrophy"
    elif label_choice == "detachment_lesion":
        ldir = "Lesion Masks/Detachment"
    else:
        raise ValueError(f"'{label_choice}' is not a valid choice of labels.")
    label_paths = util.natsorted(glob(os.path.join(data_dir, split, ldir, "*.bmp")))
    label_paths = _preprocess_labels(label_paths)
    raw_paths = [p.replace(ldir, "Images").replace("_preprocessed.tif", ".jpg")
                 for p in label_paths]
    assert len(label_paths) == len(raw_paths)
    return raw_paths, label_paths


def get_palm_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     split: str, label_choice: str = "disc", resize_inputs: bool = False,
                     download: bool = False, **kwargs):
    """Get the PALM dataset."""
    raw_paths, label_paths = get_palm_paths(path, split, label_choice, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_palm_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                    batch_size: int, split: str, label_choice: str = "disc",
                    resize_inputs: bool = False, download: bool = False,
                    **kwargs) -> DataLoader:
    """Get the PALM data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_palm_dataset(path, patch_shape, split, label_choice=label_choice,
                          resize_inputs=resize_inputs, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
