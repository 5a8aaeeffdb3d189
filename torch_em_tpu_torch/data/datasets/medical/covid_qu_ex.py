"""COVID-QU-Ex dataset: lung and infection segmentation in chest X-rays
(reference torch_em/data/datasets/medical/covid_qu_ex.py).

Located at https://www.kaggle.com/datasets/anasmohammedtahir/covidqu.
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util


def get_covid_qu_ex_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the COVID-QU-Ex data (kaggle)."""
    data_dir = os.path.join(path, "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(path, "anasmohammedtahir/covidqu", download)
    util.unzip(os.path.join(path, "covidqu.zip"), data_dir)
    return data_dir


def get_covid_qu_ex_paths(path: Union[os.PathLike, str], split: str, task: str,
                          patient_type: Optional[str] = None,
                          segmentation_mask: str = "lung",
                          download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the COVID-QU-Ex images and masks."""
    data_dir = get_covid_qu_ex_data(path, download)
    assert split.lower() in ("train", "val", "test"), f"'{split}' is not a valid split."
    if task == "lung":
        _task = "Lung Segmentation Data/Lung Segmentation Data"
    elif task == "infection":
        _task = "Infection Segmentation Data/Infection Segmentation Data"
    else:
        raise ValueError(f"'{task}' is not a valid task.")

    type_map = {"covid19": "COVID-19", "non-covid": "Non-COVID", "normal": "Normal"}
    if patient_type is None:
        patient_dir = "*"
    elif patient_type in type_map:
        patient_dir = type_map[patient_type]
    else:
        raise ValueError(f"'{patient_type}' is not a valid patient type.")

    if segmentation_mask == "lung":
        mask_dir = "lung masks"
    elif segmentation_mask == "infection":
        if task == "lung":
            raise AssertionError("The 'lung' data subset does not have infection masks.")
        mask_dir = "infection masks"
    else:
        raise ValueError(f"'{segmentation_mask}' is not a valid segmentation task.")

    base_dir = os.path.join(data_dir, _task, split.title(), patient_dir)
    image_paths = util.natsorted(glob(os.path.join(base_dir, "images", "*")))
    gt_paths = util.natsorted(glob(os.path.join(base_dir, mask_dir, "*")))
    return image_paths, gt_paths


def get_covid_qu_ex_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                            split: str, task: str, patient_type: Optional[str] = None,
                            segmentation_mask: str = "lung", resize_inputs: bool = False,
                            download: bool = False, **kwargs):
    """Get the COVID-QU-Ex dataset."""
    image_paths, gt_paths = get_covid_qu_ex_paths(path, split, task, patient_type,
                                                  segmentation_mask, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_covid_qu_ex_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                           batch_size: int, split: str, task: str,
                           patient_type: Optional[str] = None,
                           segmentation_mask: str = "lung", resize_inputs: bool = False,
                           download: bool = False, **kwargs) -> DataLoader:
    """Get the COVID-QU-Ex data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_covid_qu_ex_dataset(path, patch_shape, split, task, patient_type=patient_type,
                                 segmentation_mask=segmentation_mask,
                                 resize_inputs=resize_inputs, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
