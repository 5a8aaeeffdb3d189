"""SegThy dataset: thyroid (and vessel) segmentation in MRI and ultrasound
(reference torch_em/data/datasets/medical/segthy.py).

From https://www.cs.cit.tum.de/camp/publications/segthy-dataset/;
publication: https://doi.org/10.1371/journal.pone.0268550
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.medical_io import load_nifti, save_nifti
from .. import util

URLS = {
    "MRI": "https://www.campar.in.tum.de/public_datasets/2022_plosone_eilers/MRI_data.zip",
    "US": "https://www.campar.in.tum.de/public_datasets/2022_plosone_eilers/US_data.zip",
}
CHECKSUMS = {
    "MRI": "e9d0599b305dfe36795c45282a8495d3bfb4a872851c221b321d59ed0b11e7eb",
    "US": "52c59ef4db08adfa0e6ea562c7fe747c612f2064e01f907a78b170b02fb459bb",
}


def get_segthy_data(path: Union[os.PathLike, str], source: str, download: bool = False):
    """Download the SegThy data for one source ('MRI' / 'US')."""
    data_dir = os.path.join(path, f"{source}_volunteer_dataset")
    if os.path.exists(data_dir):
        return
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, f"{source}_data.zip")
    util.download_source(zip_path, URLS[source], download, CHECKSUMS[source])
    util.unzip(zip_path, path)
    if source == "MRI":
        # one label volume ships with a trailing singleton dim; squeeze it
        lpath = os.path.join(data_dir, "MRI_thyroid_label", "005_MRI_thyroid_label.nii.gz")
        label = np.asarray(load_nifti(lpath))
        if label.ndim == 4:
            save_nifti(lpath, label[..., 0])


def get_segthy_paths(path: Union[os.PathLike, str], split: str, source: str,
                     region: str = "thyroid",
                     download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the SegThy volumes with the reference's split slicing."""
    get_segthy_data(path, source, download)
    if source == "MRI":
        ldir = "MRI_thyroid_label" if region == "thyroid" \
            else "MRI_thyroid+jugular+carotid_label"
        label_paths = util.natsorted(
            glob(os.path.join(path, f"{source}_volunteer_dataset", ldir, "*.nii.gz")))
        raw_paths = [p.replace(ldir, "MRI") for p in label_paths]
        slices = {"thyroid": {"train": slice(0, 15), "val": slice(15, 20), "test": slice(20, None)},
                  "thyroid_and_vessels": {"train": slice(0, 8), "val": slice(8, 10),
                                          "test": slice(10, None)}}[region]
    else:
        assert region != "thyroid_and_vessels", \
            "US source does not have labels for both thyroid and vessels."
        ldir = "ground_truth_data/US_thyroid_label"
        label_paths = util.natsorted(
            glob(os.path.join(path, f"{source}_volunteer_dataset", ldir, "*.nii")))
        raw_paths = [p.replace(ldir, "ground_truth_data/US").replace(".nii", "_US.nii")
                     for p in label_paths]
        slices = {"train": slice(0, 20), "val": slice(20, 25), "test": slice(25, None)}
    if split not in slices:
        raise ValueError(f"'{split}' is not a valid split.")
    s = slices[split]
    return raw_paths[s], label_paths[s]


def get_segthy_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                       split: str, source: str, region: str = "thyroid",
                       download: bool = False, **kwargs):
    """Get the SegThy dataset."""
    raw_paths, label_paths = get_segthy_paths(path, split, source, region, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_segthy_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                      batch_size: int, split: str, source: str, region: str = "thyroid",
                      download: bool = False, **kwargs) -> DataLoader:
    """Get the SegThy data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_segthy_dataset(path, patch_shape, split, source, region=region,
                            download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
