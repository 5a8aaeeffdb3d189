"""LyNSeC dataset: lymphocyte nucleus segmentation in IHC and H&E
(reference torch_em/data/datasets/histopathology/lynsec.py).

Located at https://doi.org/10.5281/zenodo.8065174;
publication: https://doi.org/10.1016/j.compbiomed.2024.107978
"""

import json
import os
from glob import glob
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util
from ....utils.io import _pil_image

URL = "https://zenodo.org/records/8065174/files/lynsec.zip"
CHECKSUM = "14b9b5a9c39cb41afc7f31de5a995cefff0947c215e14ab9c7a463f32fbbf4b6"


def _preprocess_dataset(data_dir):
    """Split the published npy stacks into per-image tif images/labels;
    'lynsec 1' is IHC, the rest H&E (a few H&E images have mismatched labels
    and are dropped, following the reference)."""
    Image = _pil_image()

    for _dir in util.natsorted(glob(os.path.join(data_dir, "lynsec*"))):
        target_dir = "ihc" if os.path.basename(_dir) == "lynsec 1" else "h&e"
        image_dir = os.path.join(data_dir, target_dir, "images")
        label_dir = os.path.join(data_dir, target_dir, "labels")
        os.makedirs(image_dir, exist_ok=True)
        os.makedirs(label_dir, exist_ok=True)
        for fpath in util.natsorted(glob(os.path.join(_dir, "*.npy"))):
            fname = Path(fpath).stem
            if target_dir == "h&e" and fname in [f"{i}_l2" for i in range(35)]:
                continue
            darray = np.load(fpath)
            Image.fromarray(darray[..., :3].astype("uint8")).save(
                os.path.join(image_dir, f"{fname}.tif"))
            Image.fromarray(darray[..., 3].astype("int32"), mode="I").save(
                os.path.join(label_dir, f"{fname}.tif"))


def get_lynsec_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the LyNSeC data."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(data_dir, exist_ok=True)
    zip_path = os.path.join(path, "lynsec.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, data_dir)
    _preprocess_dataset(data_dir)
    return data_dir


def _split_list(path, data_dir, split, choice):
    import pandas as pd
    csv_path = os.path.join(path, f"lynsec_{choice.replace('&', '')}_split.csv")
    if os.path.exists(csv_path):
        df = pd.read_csv(csv_path)
        df[split] = df[split].apply(lambda x: json.loads(x.replace("'", '"')))
        return df.iloc[0][split]
    names = [Path(p).stem for p in glob(os.path.join(data_dir, choice, "images", "*.tif"))]
    train_ids, test_ids = util._train_test_split(names, test_size=0.2)
    train_ids, val_ids = util._train_test_split(train_ids, test_size=0.15)
    split_ids = {"train": train_ids, "val": val_ids, "test": test_ids}
    pd.DataFrame.from_dict([split_ids]).to_csv(csv_path, index=False)
    return split_ids[split]


def get_lynsec_paths(path: Union[os.PathLike, str], split: Optional[str] = None,
                     choice: Optional[str] = None,
                     download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the LyNSeC images and labels
    (choice: 'ihc' / 'h&e' / None for both)."""
    data_dir = get_lynsec_data(path, download)
    choices = ["ihc", "h&e"] if choice is None else [choice]
    raw_paths, label_paths = [], []
    for c in choices:
        curr_raw = util.natsorted(glob(os.path.join(data_dir, c, "images", "*.tif")))
        curr_labels = util.natsorted(glob(os.path.join(data_dir, c, "labels", "*.tif")))
        if split is not None:
            names = set(_split_list(path, data_dir, split, c))
            curr = [(r, l) for r, l in zip(curr_raw, curr_labels) if Path(r).stem in names]
            curr_raw = [r for r, _ in curr]
            curr_labels = [l for _, l in curr]
        raw_paths.extend(curr_raw)
        label_paths.extend(curr_labels)
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_lynsec_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                       split: Optional[str] = None, choice: Optional[str] = None,
                       download: bool = False, **kwargs):
    """Get the LyNSeC dataset for lymphocyte nucleus segmentation."""
    raw_paths, label_paths = get_lynsec_paths(path, split, choice, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_lynsec_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                      batch_size: int, split: Optional[str] = None,
                      choice: Optional[str] = None, download: bool = False,
                      **kwargs) -> DataLoader:
    """Get the LyNSeC data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_lynsec_dataset(path, patch_shape, split=split, choice=choice,
                            download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
