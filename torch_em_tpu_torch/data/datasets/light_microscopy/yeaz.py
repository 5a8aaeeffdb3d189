"""YeaZ dataset: yeast cell segmentation in phase-contrast and brightfield
microscopy (reference torch_em/data/datasets/light_microscopy/yeaz.py).

The data must be downloaded manually from
https://www.epfl.ch/labs/lpbs/data-and-software/ (google drive links),
placing the tarballs at ``path``.
"""

import json
import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = {
    "phc": "https://drive.google.com/file/d/14MUIN26ou0L12UC9UV_AC2S3isj1qBMY",
    "bf": "https://drive.google.com/file/d/1Sot3bau0F0dsBjRxoQzdGOeUy_wMezal",
}
DIR_NAMES = {"phc": "gold-standard-PhC-plus-2", "bf": "gold-standard-BF-V-1"}


def get_yeaz_data(path: Union[os.PathLike, str], choice: str = "phc",
                  download: bool = False) -> str:
    """Unpack the manually downloaded YeaZ tarball for 'phc' or 'bf'."""
    if choice not in DIR_NAMES:
        raise ValueError(f"'{choice}' is not a valid choice of dataset.")
    data_dir = os.path.join(path, DIR_NAMES[choice])
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    tar_path = os.path.join(path, f"{DIR_NAMES[choice]}.tar.gz")
    if not os.path.exists(tar_path) or download:
        raise NotImplementedError(
            f"Automatic download is not supported; fetch the data manually from '{URL[choice]}'.")
    util.unzip_tarfile(tar_path, path, remove=False)
    return data_dir


def _create_data_splits(path, choice, split, raw_paths):
    json_file = os.path.join(path, f"yeaz_{choice}_splits.json")
    if os.path.exists(json_file):
        with open(json_file) as f:
            data = json.load(f)
    else:
        names = [os.path.basename(p) for p in raw_paths]
        train_split, test_split = util._train_test_split(names, test_size=0.2)
        train_split, val_split = util._train_test_split(train_split, test_size=0.15)
        data = {"train": train_split, "val": val_split, "test": test_split}
        with open(json_file, "w") as f:
            json.dump(data, f)
    data_dir = os.path.dirname(raw_paths[0])
    split_raw = [os.path.join(data_dir, name) for name in data[split]]
    split_label = [p.replace("_im.tif", "_mask.tif") for p in split_raw]
    return split_raw, split_label


def get_yeaz_paths(path: Union[os.PathLike, str], choice: str, split: str,
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the YeaZ images and instance masks for a split."""
    data_dir = get_yeaz_data(path, choice, download)
    raw_paths = util.natsorted(glob(os.path.join(data_dir, "*_im.tif")))
    assert split in ("train", "val", "test"), f"'{split}' is not a valid split."
    return _create_data_splits(path, choice, split, raw_paths)


def get_yeaz_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     choice: str, split: str, download: bool = False, **kwargs):
    """Get the YeaZ dataset for yeast cell segmentation."""
    raw_paths, label_paths = get_yeaz_paths(path, choice, split, download)
    return default_segmentation_dataset(
        raw_paths, None, label_paths, None, patch_shape,
        is_seg_dataset=False, **kwargs,
    )


def get_yeaz_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                    batch_size: int, choice: str, split: str,
                    download: bool = False, **kwargs) -> DataLoader:
    """Get the YeaZ data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_yeaz_dataset(path, patch_shape, choice, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
