"""TNBC dataset: nucleus segmentation in triple-negative breast cancer H&E
(reference torch_em/data/datasets/histopathology/tnbc.py).

Located at https://doi.org/10.5281/zenodo.1175282.
"""

import json
import os
import shutil
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URL = "https://zenodo.org/records/1175282/files/TNBC_NucleiSegmentation.zip"
CHECKSUM = "da708c3a988f4ad4b9bbb9283b387faf703f0bc0e5e689927306bd27ea13a57f"


def _create_split_csv(path, data_dir, split):
    """Create (or read) a persistent random train/val/test split (80/65-15/20)."""
    import pandas as pd
    csv_path = os.path.join(path, "tnbc_split.csv")
    if os.path.exists(csv_path):
        df = pd.read_csv(csv_path)
        df[split] = df[split].apply(lambda x: json.loads(x.replace("'", '"')))
        return df.iloc[0][split]
    image_names = [
        os.path.basename(image).split(".")[0] for image in glob(os.path.join(data_dir, "*.h5"))
    ]
    train_ids, test_ids = util._train_test_split(image_names, test_size=0.2)
    train_ids, val_ids = util._train_test_split(train_ids, test_size=0.15)
    split_ids = {"train": train_ids, "val": val_ids, "test": test_ids}
    pd.DataFrame.from_dict([split_ids]).to_csv(csv_path, index=False)
    return split_ids[split]


def _preprocess_images(path):
    h5py = _h5py()

    from ....ops.host import connected_components

    raw_paths = util.natsorted(glob(os.path.join(path, "TNBC_NucleiSegmentation", "Slide_*", "*.png")))
    label_paths = util.natsorted(glob(os.path.join(path, "TNBC_NucleiSegmentation", "GT_*", "*.png")))
    preprocessed_dir = os.path.join(path, "preprocessed")
    os.makedirs(preprocessed_dir, exist_ok=True)

    for rpath, lpath in zip(raw_paths, label_paths):
        raw = np.asarray(load_image(rpath))
        if raw.ndim == 3 and raw.shape[-1] == 4:
            raw = raw[..., :-1]  # drop the empty alpha channel
        raw = raw.transpose(2, 0, 1)
        label = np.asarray(load_image(lpath))
        with h5py.File(os.path.join(preprocessed_dir, f"{Path(lpath).stem}.h5"), "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels/semantic", data=label, compression="gzip")
            f.create_dataset("labels/instances", data=connected_components(label),
                             compression="gzip")

    shutil.rmtree(os.path.join(path, "TNBC_NucleiSegmentation"))
    macosx = os.path.join(path, "__MACOSX")
    if os.path.exists(macosx):
        shutil.rmtree(macosx)


def get_tnbc_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and preprocess the TNBC data."""
    data_dir = os.path.join(path, "preprocessed")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "TNBC_NucleiSegmentation.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    _preprocess_images(path)
    return data_dir


def get_tnbc_paths(path: Union[os.PathLike, str], split: str,
                   download: bool = False) -> List[str]:
    """Get paths to the TNBC volumes for a split ('train' / 'val' / 'test')."""
    data_dir = get_tnbc_data(path, download)
    names = _create_split_csv(path, data_dir, split)
    return [os.path.join(data_dir, f"{name}.h5") for name in names]


def get_tnbc_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     split: str, label_choice: str = "instances",
                     download: bool = False, **kwargs):
    """Get the TNBC dataset for nucleus segmentation
    (label_choice: 'instances' or 'semantic')."""
    paths = get_tnbc_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, f"labels/{label_choice}",
                                        patch_shape, ndim=2, with_channels=True, **kwargs)


def get_tnbc_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                    batch_size: int, split: str, label_choice: str = "instances",
                    download: bool = False, **kwargs) -> DataLoader:
    """Get the TNBC data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_tnbc_dataset(path, patch_shape, split, label_choice=label_choice,
                          download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
