"""KiTS23 dataset: kidney, tumor and cyst segmentation in CT
(reference torch_em/data/datasets/medical/kits.py).

Data comes from the KiTS23 challenge (https://kits-challenge.org/kits23/);
the download clones https://github.com/neheller/kits23 and runs its
download CLI. Patients are converted to h5 with 'raw', 'labels/all' and
per-rater 'labels/{kidney,tumor,cyst}/rater_{i}' masks.
"""

import json
import os
import subprocess
from glob import glob
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.medical_io import load_nifti
from .. import util
from ....utils.io import _h5py

URL = "https://github.com/neheller/kits23"
VALID_SPLITS = ("train", "val", "test")


def _rater_masks(patient_dir, annotation, raw_shape):
    """Merge all instance annotations of one class into per-rater binary masks."""
    ann_paths = util.natsorted(glob(
        os.path.join(patient_dir, "instances", f"{annotation}_instance*")))
    raters = sorted({p[-8] for p in ann_paths})  # '<name>_instance-<k>-<rater>.nii.gz'
    masks = {}
    for rater in raters:
        mask = np.zeros(raw_shape, dtype="uint8")
        for p in glob(os.path.join(patient_dir, "instances",
                                   f"{annotation}_instance*-{rater}.nii.gz")):
            mask[np.asarray(load_nifti(p)) > 0] = 1
        masks[rater] = mask
    return masks


def _preprocess_inputs(path):
    h5py = _h5py()

    patient_dirs = glob(os.path.join(path, "kits23", "dataset", "case*"))
    preprocessed_dir = os.path.join(path, "preprocessed")
    for split in VALID_SPLITS:
        os.makedirs(os.path.join(preprocessed_dir, split), exist_ok=True)

    json_path = os.path.join(path, "splits_kits.json")
    if os.path.exists(json_path):
        with open(json_path) as f:
            split_info = json.load(f)
        split_map = {
            os.path.join(path, "kits23", "dataset", Path(fname).stem): split
            for split, fnames in split_info.items() for fname in fnames
        }
        write_json = False
    else:
        train_dirs, test_dirs = util._train_test_split(patient_dirs, test_size=0.25, random_state=42)
        train_dirs, val_dirs = util._train_test_split(train_dirs, test_size=0.1, random_state=42)
        split_map = {**{d: "train" for d in train_dirs}, **{d: "val" for d in val_dirs},
                     **{d: "test" for d in test_dirs}}
        split_info = {"train": [], "val": [], "test": []}
        write_json = True

    for patient_dir in patient_dirs:
        patient_id = os.path.basename(patient_dir)
        split = split_map[patient_dir]
        patient_fname = str(Path(patient_id).with_suffix(".h5"))
        patient_path = os.path.join(preprocessed_dir, split, patient_fname)
        if write_json:
            split_info[split].append(patient_fname)
        if os.path.exists(patient_path):
            continue
        raw = np.asarray(load_nifti(os.path.join(patient_dir, "imaging.nii.gz")))
        labels = np.asarray(load_nifti(os.path.join(patient_dir, "segmentation.nii.gz")))
        assert raw.shape == labels.shape
        with h5py.File(patient_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels/all", data=labels, compression="gzip")
            for annotation in ("kidney", "tumor", "cyst"):
                for rater, mask in _rater_masks(patient_dir, annotation, raw.shape).items():
                    f.create_dataset(f"labels/{annotation}/rater_{rater}", data=mask,
                                     compression="gzip")
    if write_json:
        with open(json_path, "w") as f:
            json.dump(split_info, f, indent=2)


def get_kits_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download (via the kits23 CLI) and preprocess the KiTS23 data."""
    data_dir = os.path.join(path, "preprocessed")
    if os.path.exists(data_dir) and all(
            os.path.exists(os.path.join(data_dir, s)) for s in VALID_SPLITS):
        return data_dir
    os.makedirs(path, exist_ok=True)
    if not download:
        raise RuntimeError("The dataset is not found and download is set to False.")
    if not os.path.exists(os.path.join(path, "kits23")):
        subprocess.run(["git", "clone", URL, os.path.join(path, "kits23")], check=True)
    case_dirs = util.natsorted(glob(os.path.join(path, "kits23", "dataset", "case*")))
    if not case_dirs or not os.path.exists(os.path.join(case_dirs[-1], "imaging.nii.gz")):
        subprocess.run(["pip", "install", "-e", os.path.join(path, "kits23"), "--no-deps"])
        print("The download might take several hours.")
        subprocess.run(["kits23_download_data"], check=True)
    _preprocess_inputs(path)
    return data_dir


def get_kits_paths(path: Union[os.PathLike, str], split: str,
                   download: bool = False) -> List[str]:
    """Get paths to the preprocessed KiTS23 h5 volumes for a split."""
    if split not in VALID_SPLITS:
        raise ValueError(f"Invalid split '{split}'. Must be one of {VALID_SPLITS}.")
    get_kits_data(path, download)
    volume_paths = util.natsorted(glob(os.path.join(path, "preprocessed", split, "*.h5")))
    if not volume_paths:
        raise RuntimeError(f"No .h5 files found for split '{split}'.")
    return volume_paths


def get_kits_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                     split: str, rater: Optional[int] = None,
                     annotation_choice: Optional[str] = None,
                     download: bool = False, **kwargs):
    """Get the KiTS23 dataset; rater/annotation_choice select a per-rater
    binary mask, otherwise the combined semantic labels are used."""
    volume_paths = get_kits_paths(path, split, download)
    if rater is None and annotation_choice is None:
        label_key = "labels/all"
    else:
        assert rater is not None and annotation_choice is not None, \
            "Both rater and annotation_choice must be specified together."
        label_key = f"labels/{annotation_choice}/rater_{rater}"
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(volume_paths, "raw", volume_paths, label_key,
                                        patch_shape, **kwargs)


def get_kits_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                    batch_size: int, split: str, rater: Optional[int] = None,
                    annotation_choice: Optional[str] = None,
                    download: bool = False, **kwargs) -> DataLoader:
    """Get the KiTS23 data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_kits_dataset(path, patch_shape, split, rater=rater,
                          annotation_choice=annotation_choice, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
