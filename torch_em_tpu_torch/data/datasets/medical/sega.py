"""SegA dataset: aorta segmentation in CT (SEG.A. challenge)
(reference torch_em/data/datasets/medical/sega.py).

Publication: https://doi.org/10.1007/978-3-031-53241-2
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.medical_io import load_nrrd, save_nifti
from .. import util

URL = {
    "kits": "https://figshare.com/ndownloader/files/30950821",
    "rider": "https://figshare.com/ndownloader/files/30950914",
    "dongyang": "https://figshare.com/ndownloader/files/30950971",
}
CHECKSUMS = {
    "kits": "6c9c2ea31e5998348acf1c4f6683ae07041bd6c8caf309dd049adc7f222de26e",
    "rider": "7244038a6a4f70ae70b9288a2ce874d32128181de2177c63a7612d9ab3c4f5fa",
    "dongyang": "0187e90038cba0564e6304ef0182969ff57a31b42c5969d2b9188a27219da541",
}
ZIPFILES = {"kits": "KiTS.zip", "rider": "Rider.zip", "dongyang": "Dongyang.zip"}


def get_sega_data(path: Union[os.PathLike, str], data_choice: str,
                  download: bool = False) -> str:
    """Download the SegA data for one source ('kits'/'rider'/'dongyang')."""
    assert data_choice in URL, f"Invalid data choice: {data_choice}"
    zip_fid = ZIPFILES[data_choice]
    data_dir = os.path.join(path, Path(zip_fid).stem)
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, zip_fid)
    util.download_source(zip_path, URL[data_choice], download, CHECKSUMS[data_choice])
    util.unzip(zip_path, path)
    return data_dir


def get_sega_paths(path: Union[os.PathLike, str],
                   data_choice: Optional[str] = None,
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the SegA volumes (nrrd inputs converted to nifti)."""
    data_choices = list(URL.keys()) if data_choice is None else [data_choice]
    data_dirs = [get_sega_data(path, c, download) for c in data_choices]

    image_paths, gt_paths = [], []
    for data_dir in data_dirs:
        for volume_path in glob(os.path.join(data_dir, "*", "*.nrrd")):
            if volume_path.endswith(".seg.nrrd"):
                gt_paths.append(volume_path)
            else:
                image_paths.append(volume_path)

    fimage_dir = os.path.join(path, "data", "images")
    fgt_dir = os.path.join(path, "data", "labels")
    os.makedirs(fimage_dir, exist_ok=True)
    os.makedirs(fgt_dir, exist_ok=True)

    fimage_paths, fgt_paths = [], []
    for image_path, gt_path in zip(util.natsorted(image_paths), util.natsorted(gt_paths)):
        fimage_path = os.path.join(fimage_dir, f"{Path(image_path).stem}.nii.gz")
        fgt_path = os.path.join(fgt_dir, f"{Path(image_path).stem}.nii.gz")
        fimage_paths.append(fimage_path)
        fgt_paths.append(fgt_path)
        if os.path.exists(fimage_path) and os.path.exists(fgt_path):
            continue
        save_nifti(fimage_path, np.asarray(load_nrrd(image_path)))
        gt = np.asarray(load_nrrd(gt_path))
        if gt.ndim == 4:  # 3D Slicer segmentation nrrds may carry a layer axis
            gt = gt[0] if gt.shape[0] < min(gt.shape[1:]) else gt[..., 0]
        save_nifti(fgt_path, gt)
    assert len(fimage_paths) == len(fgt_paths)
    return fimage_paths, fgt_paths


def get_sega_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                     data_choice: Optional[str] = None, download: bool = False, **kwargs):
    """Get the SegA dataset for aorta segmentation."""
    image_paths, gt_paths = get_sega_paths(path, data_choice, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(image_paths, None, gt_paths, None, patch_shape, **kwargs)


def get_sega_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                    batch_size: int, data_choice: Optional[str] = None,
                    download: bool = False, **kwargs) -> DataLoader:
    """Get the SegA data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_sega_dataset(path, patch_shape, data_choice=data_choice,
                          download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
