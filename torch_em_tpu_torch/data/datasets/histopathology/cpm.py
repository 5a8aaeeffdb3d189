"""CPM datasets (cpm15 / cpm17): nucleus segmentation in H&E
(reference torch_em/data/datasets/histopathology/cpm.py).

The data must be downloaded manually from
https://drive.google.com/drive/folders/1l55cv3DuY-f7-JotDN7N5nbNnjbLWchK;
publication: https://doi.org/10.3389/fbioe.2019.00053
"""

import json
import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util
from ....utils.io import _pil_image

URL = {
    "cpm15": "https://drive.google.com/drive/folders/11ko-GcDsPpA9GBHuCtl_jNzWQl6qY_-I?usp=drive_link",
    "cpm17": "https://drive.google.com/drive/folders/1sJ4nmkif6j4s2FOGj8j6i_Ye7z9w0TfA?usp=drive_link",
}


def _create_split_csv(path, split):
    import pandas as pd
    csv_path = os.path.join(path, "cpm15_split.csv")
    if os.path.exists(csv_path):
        df = pd.read_csv(csv_path)
        df[split] = df[split].apply(lambda x: json.loads(x.replace("'", '"')))
        return df.iloc[0][split]
    image_names = [
        os.path.basename(image).split(".")[0]
        for image in glob(os.path.join(path, "cpm15", "Images", "*.png"))
    ]
    train_ids, test_ids = util._train_test_split(image_names, test_size=0.25)
    train_ids, val_ids = util._train_test_split(train_ids, test_size=0.20)
    split_ids = {"train": train_ids, "val": val_ids, "test": test_ids}
    pd.DataFrame.from_dict([split_ids]).to_csv(csv_path, index=False)
    return split_ids[split]


def get_cpm_data(path: Union[os.PathLike, str], data_choice: str,
                 download: bool = False) -> str:
    """Unpack the manually downloaded CPM data ('cpm15' / 'cpm17')."""
    if data_choice not in ("cpm15", "cpm17"):
        raise ValueError(f"'{data_choice}' is not a valid data choice.")
    data_dir = os.path.join(path, data_choice)
    if os.path.exists(data_dir):
        return data_dir
    if download:
        raise NotImplementedError(
            "The CPM data cannot be downloaded automatically; download the folder from "
            f"'{URL[data_choice]}' as a zip and place it at {path}."
        )
    os.makedirs(path, exist_ok=True)
    zip_paths = glob(os.path.join(path, f"{data_choice}*.zip"))
    if not zip_paths:
        raise AssertionError(
            f"No zip file for '{data_choice}' found; download it from '{URL[data_choice]}'.")
    util.unzip(zip_paths[0], path, remove=False)
    return data_dir


def get_cpm_paths(path: Union[os.PathLike, str], data_choice: str, split: str,
                  download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the CPM images and (mat->tif converted) instance labels."""
    Image = _pil_image()
    from scipy.io import loadmat

    data_dir = get_cpm_data(path, data_choice, download)
    if data_choice == "cpm15":
        split_list = _create_split_csv(path, split)
        raw_paths = [os.path.join(data_dir, "Images", f"{f}.png") for f in split_list]
        label_mat_paths = [os.path.join(data_dir, "Labels", f"{f}.mat") for f in split_list]
    else:
        assert split in ("train", "test"), "No explicit val split exists for cpm17."
        raw_paths = util.natsorted(glob(os.path.join(data_dir, split, "Images", "*.png")))
        label_mat_paths = util.natsorted(glob(os.path.join(data_dir, split, "Labels", "*.mat")))

    label_paths = []
    for mpath in label_mat_paths:
        label_path = mpath.replace(".mat", "_instance_labels.tif")
        label_paths.append(label_path)
        if os.path.exists(label_path):
            continue
        label = loadmat(mpath)["inst_map"]
        Image.fromarray(np.asarray(label).astype("int32"), mode="I").save(label_path)
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_cpm_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                    data_choice: str, split: str, download: bool = False, **kwargs):
    """Get the CPM dataset for nucleus segmentation."""
    raw_paths, label_paths = get_cpm_paths(path, data_choice, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_cpm_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                   batch_size: int, data_choice: str, split: str,
                   download: bool = False, **kwargs) -> DataLoader:
    """Get the CPM data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_cpm_dataset(path, patch_shape, data_choice, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
