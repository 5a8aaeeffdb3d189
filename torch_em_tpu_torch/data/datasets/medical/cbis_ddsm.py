"""CBIS-DDSM dataset: lesion segmentation in mammography
(reference torch_em/data/datasets/medical/cbis_ddsm.py).

Located at https://www.kaggle.com/datasets/mohamedbenticha/cbis-ddsm/.
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util
from ....utils.io import _pil_image


def get_cbis_ddsm_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the CBIS-DDSM data (kaggle)."""
    data_dir = os.path.join(path, "DATA")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(path, "mohamedbenticha/cbis-ddsm/", download)
    util.unzip(os.path.join(path, "cbis-ddsm.zip"), path)
    return data_dir


def _check_if_size_matches(image_path, gt_path):
    Image = _pil_image()

    return Image.open(image_path).size == Image.open(gt_path).size


def get_cbis_ddsm_paths(path: Union[os.PathLike, str], split: str,
                        task: Optional[str] = None, tumour_type: Optional[str] = None,
                        download: bool = False,
                        ignore_mismatching_pairs: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the CBIS-DDSM mammograms and lesion masks (the published
    train set is re-split, first 125 pairs as val)."""
    data_dir = get_cbis_ddsm_data(path, download)
    if split not in ("Train", "Val", "Test"):
        raise ValueError(f"'{split}' is not a valid split.")
    task = "*" if task is None else task
    assert task in ("Calc", "Mass", "*"), f"'{task}' is not a valid task."
    tumour_type = "*" if tumour_type is None else tumour_type
    assert tumour_type in ("MALIGNANT", "BENIGN", "*"), f"Invalid tumour type: {tumour_type}"

    def _filter(image_paths, gt_paths):
        pairs = [(ip, gp) for ip, gp in zip(image_paths, gt_paths)
                 if _check_if_size_matches(ip, gp)]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    folder = "Test" if split == "Test" else "Train"
    target_dir = os.path.join(data_dir, task, folder, tumour_type)
    image_paths = util.natsorted(glob(os.path.join(target_dir, "*_FULL_*.png")))
    gt_paths = util.natsorted(glob(os.path.join(target_dir, "*_MASK_*.png")))
    if ignore_mismatching_pairs:
        image_paths, gt_paths = _filter(image_paths, gt_paths)
    if split == "Train":
        image_paths, gt_paths = image_paths[125:], gt_paths[125:]
    elif split == "Val":
        image_paths, gt_paths = image_paths[:125], gt_paths[:125]
    assert len(image_paths) == len(gt_paths)
    return image_paths, gt_paths


def get_cbis_ddsm_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          split: str, task: Optional[str] = None,
                          tumour_type: Optional[str] = None, resize_inputs: bool = False,
                          download: bool = False, **kwargs):
    """Get the CBIS-DDSM dataset for lesion segmentation."""
    image_paths, gt_paths = get_cbis_ddsm_paths(
        path, split, task, tumour_type, download, ignore_mismatching_pairs=resize_inputs)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": False}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs, patch_shape, resize_inputs, resize_kwargs,
        )
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_cbis_ddsm_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         batch_size: int, split: str, task: Optional[str] = None,
                         tumour_type: Optional[str] = None, resize_inputs: bool = False,
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the CBIS-DDSM data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_cbis_ddsm_dataset(path, patch_shape, split, task=task, tumour_type=tumour_type,
                               resize_inputs=resize_inputs, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
