"""CryoNuSeg dataset: nucleus segmentation in cryosectioned H&E
(reference torch_em/data/datasets/histopathology/cryonuseg.py).

Publication: https://doi.org/10.1016/j.compbiomed.2021.104349
"""

import json
import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util


def _create_split_csv(path, data_dir, split):
    import pandas as pd
    csv_path = os.path.join(path, "cryonuseg_split.csv")
    if os.path.exists(csv_path):
        df = pd.read_csv(csv_path)
        df[split] = df[split].apply(lambda x: json.loads(x.replace("'", '"')))
        return df.iloc[0][split]
    image_names = [
        os.path.basename(image).split(".")[0]
        for image in glob(os.path.join(path, data_dir, "*.tif"))
    ]
    train_ids, test_ids = util._train_test_split(image_names, test_size=0.2)
    train_ids, val_ids = util._train_test_split(train_ids, test_size=0.15)
    split_ids = {"train": train_ids, "val": val_ids, "test": test_ids}
    pd.DataFrame.from_dict([split_ids]).to_csv(csv_path, index=False)
    return split_ids[split]


def get_cryonuseg_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the CryoNuSeg data (kaggle)."""
    data_dir = os.path.join(path, "tissue images")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(
        path, "ipateam/segmentation-of-nuclei-in-cryosectioned-he-images", download)
    zip_path = os.path.join(path, "segmentation-of-nuclei-in-cryosectioned-he-images.zip")
    util.unzip(zip_path, path)
    return data_dir


def get_cryonuseg_paths(path: Union[os.PathLike, str], split: str,
                        rater_choice: str = "b1",
                        download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the CryoNuSeg images and instance labels for one of the
    three annotation rounds ('b1' / 'b2' / 'b3')."""
    data_dir = get_cryonuseg_data(path, download)
    if rater_choice == "b1":
        label_dir = "Annotator 1 (biologist)/"
    elif rater_choice == "b2":
        label_dir = "Annotator 1 (biologist second round of manual marks up)/" * 2
    elif rater_choice == "b3":
        label_dir = "Annotator 2 (bioinformatician)/" * 2
    else:
        raise ValueError(f"'{rater_choice}' is not a valid rater choice.")
    label_dir += "label masks modify"
    split_list = _create_split_csv(path, label_dir, split)
    label_paths = util.natsorted(
        [os.path.join(path, label_dir, f"{fname}.tif") for fname in split_list])
    raw_paths = util.natsorted(
        [os.path.join(data_dir, f"{fname}.tif") for fname in split_list])
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_cryonuseg_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          split: str, rater: str = "b1", download: bool = False, **kwargs):
    """Get the CryoNuSeg dataset for nucleus segmentation."""
    raw_paths, label_paths = get_cryonuseg_paths(path, split, rater, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_cryonuseg_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         batch_size: int, split: str, rater: str = "b1",
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the CryoNuSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_cryonuseg_dataset(path, patch_shape, split, rater=rater,
                               download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
