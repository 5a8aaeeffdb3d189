"""PCNS dataset: nucleus instance segmentation in H&E histopathology patches
of fourteen TCGA cancer types (reference
torch_em/data/datasets/histopathology/pcns.py).

1,365 manually annotated 400x400 patches at 40x magnification (BLCA, BRCA,
CESC, COAD, GBM, LUAD, LUSC, PAAD, PRAD, READ, SKCM, STAD, UCEC, UVM).
Requires manual download of 'manual_segmentation_data.tar.gz' from
https://www.cancerimagingarchive.net/analysis-result/pan-cancer-nuclei-seg/.
Data DOI https://doi.org/10.7937/TCIA.2019.4A4DKP9U; publication
https://doi.org/10.1038/s41597-020-0528-1.
"""

import csv
import gzip
import json
import os
import shutil
import tarfile
from glob import glob
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

CROSSWALK_URL = (
    "https://www.cancerimagingarchive.net/wp-content/uploads/"
    "Pan-Cancer-Nuclei-Seg_1365patches_to_TCGA-ID_readme.txt"
)

BOX_URL = "https://stonybrookmedicine.app.box.com/v/cnn-nuclear-segmentations-2019/file/586046955275"

CANCER_TYPES = [
    "blca", "brca", "cesc", "coad", "gbm", "luad", "lusc",
    "paad", "prad", "read", "skcm", "stad", "ucec", "uvm",
]


def _load_crosswalk(path: str) -> dict:
    """Patch-ID -> cancer-type mapping from the TCIA crosswalk readme.

    The readme is prose followed by an embedded CSV table whose header row
    starts with ``Patch-ID,``; some mirrors serve it gzip-compressed without a
    .gz suffix, so the magic bytes decide how to decode.
    """
    crosswalk_path = os.path.join(path, "pcns_crosswalk.txt")
    if not os.path.exists(crosswalk_path):
        util.download_source(path=crosswalk_path, url=CROSSWALK_URL, download=True)

    blob = open(crosswalk_path, "rb").read()
    gzip_magic = blob.startswith(b"\x1f\x8b")
    text = (gzip.decompress(blob) if gzip_magic else blob).decode("utf-8")

    table = {}
    reader = None
    for line in text.splitlines():
        if reader is None:
            if line.startswith("Patch-ID,"):
                header = line.split(",")
                reader = (header.index("Patch-ID"), header.index("CancerType"))
            continue
        cells = next(csv.reader([line]), [])
        if len(cells) <= max(reader):
            continue
        pid, cancer = cells[reader[0]].strip(), cells[reader[1]].strip()
        try:
            pid = int(float(pid))
        except ValueError:  # prose after the table, or a row whose first cell is not a patch id
            continue
        if cancer:
            table[pid] = cancer.lower()
    if reader is None:
        raise RuntimeError("Failed to parse the PCNS crosswalk file. Re-download it and try again.")
    return table


def _read_or_create_split(path: str, all_patch_ids: List[int], split: str) -> List[int]:
    """Random 80/20 train/test split of patch ids, persisted as JSON so every
    later call (and process) sees the same assignment."""
    split_path = os.path.join(path, "pcns_split.json")
    legacy_csv = os.path.join(path, "pcns_split.csv")
    if not os.path.exists(split_path) and os.path.exists(legacy_csv):
        # migrate the pre-round-5 pandas one-row CSV (columns train/test with
        # stringified id lists) so existing data dirs keep their assignment
        import csv

        with open(legacy_csv, newline="") as f:
            row = next(csv.DictReader(f))
        assignment = {k: sorted(json.loads(row[k].replace("'", '"')))
                      for k in ("train", "test")}
        with open(split_path, "w") as f:
            json.dump(assignment, f)
    if not os.path.exists(split_path):
        ids = np.random.permutation(sorted(all_patch_ids))
        n_test = int(round(0.2 * len(ids)))
        assignment = {"test": sorted(int(i) for i in ids[:n_test]),
                      "train": sorted(int(i) for i in ids[n_test:])}
        with open(split_path, "w") as f:
            json.dump(assignment, f)
    with open(split_path) as f:
        return json.load(f)[split]


def _sibling_mask(crop_path: str, suffix: str) -> str:
    return crop_path[: -len("_crop.png")] + suffix


def _create_samples(path: str, extract_dir: str, cancer_by_id: dict) -> str:
    """Build one h5 per annotated patch: raw RGB as (3, H, W), the corrected
    instance mask under labels/instances, and the three per-annotator
    agreement masks under labels/common{0,1,2} (zero-filled when an annotator
    mask is missing, recorded in the ``has_common`` attribute)."""
    h5py = _h5py()

    preprocessed_dir = os.path.join(path, "preprocessed_data")
    if os.path.exists(preprocessed_dir):
        return preprocessed_dir
    os.makedirs(preprocessed_dir, exist_ok=True)

    for crop_path in sorted(glob(os.path.join(extract_dir, "**", "*_crop.png"), recursive=True)):
        if not os.path.exists(_sibling_mask(crop_path, "_labeled_mask_corrected.png")):
            continue  # only manually corrected patches are part of the dataset
        patch_id = int(os.path.basename(crop_path).split("_crop")[0])

        rgb = np.asarray(load_image(crop_path))[..., :3]
        instances = np.asarray(
            load_image(_sibling_mask(crop_path, "_labeled_mask_corrected.png"))).astype(np.int32)
        annotator_masks = []
        for k in range(3):
            mask_path = _sibling_mask(crop_path, f"_labeled_mask_common{k}.png")
            annotator_masks.append(
                np.asarray(load_image(mask_path)).astype(np.int32)
                if os.path.exists(mask_path) else None)

        with h5py.File(os.path.join(preprocessed_dir, f"{patch_id}.h5"), "w") as f:
            f.create_dataset("raw", data=rgb.transpose(2, 0, 1), compression="gzip")
            f.create_dataset("labels/instances", data=instances, compression="gzip")
            for k, mask in enumerate(annotator_masks):
                f.create_dataset(
                    f"labels/common{k}", compression="gzip",
                    data=np.zeros_like(instances) if mask is None else mask)
            f.attrs["cancer_type"] = cancer_by_id.get(patch_id, "unknown")
            f.attrs["has_common"] = all(m is not None for m in annotator_masks)
    return preprocessed_dir


def get_pcns_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Extract the manually-downloaded PCNS tarball and build per-sample h5s."""
    path = os.path.normpath(str(path))
    preprocessed_dir = os.path.join(path, "preprocessed_data")
    if os.path.exists(preprocessed_dir):
        return preprocessed_dir

    tar_path = os.path.join(path, "manual_segmentation_data.tar.gz")
    if download:
        raise RuntimeError(
            "The PCNS dataset cannot be downloaded automatically. "
            f"Please download 'manual_segmentation_data.tar.gz' manually from {BOX_URL} "
            f"and place it at '{tar_path}'.")
    if not os.path.exists(tar_path):
        raise RuntimeError(
            "The PCNS dataset requires manual download. "
            f"Please download 'manual_segmentation_data.tar.gz' from {BOX_URL} "
            f"and place it at '{tar_path}'.")

    extract_dir = os.path.join(path, "_raw")
    os.makedirs(extract_dir, exist_ok=True)
    with tarfile.open(tar_path, "r:gz") as tar:
        tar.extractall(path=extract_dir)

    _create_samples(path, extract_dir, _load_crosswalk(path))
    shutil.rmtree(extract_dir)
    return preprocessed_dir


def get_pcns_paths(path: Union[os.PathLike, str], split: str,
                   cancer_type: Optional[Union[str, List[str]]] = None,
                   download: bool = False) -> List[str]:
    """Per-sample h5 paths for a split, optionally filtered by cancer type."""
    if split not in ("train", "test"):
        raise ValueError(f"'{split}' is not a valid split. Choose from 'train' or 'test'.")

    preprocessed_dir = get_pcns_data(path, download)
    cancer_by_id = _load_crosswalk(os.path.normpath(str(path)))
    wanted = set(_read_or_create_split(
        os.path.normpath(str(path)), list(cancer_by_id), split))

    if cancer_type is not None:
        selected = [cancer_type] if isinstance(cancer_type, str) else list(cancer_type)
        selected = [ct.lower() for ct in selected]
        invalid = sorted(set(selected) - set(CANCER_TYPES))
        if invalid:
            raise ValueError(f"Invalid cancer type(s): {invalid}. Choose from {CANCER_TYPES}.")
        wanted = {pid for pid in wanted if cancer_by_id.get(pid) in selected}

    volume_paths = [os.path.join(preprocessed_dir, f"{pid}.h5") for pid in sorted(wanted)]
    volume_paths = [p for p in volume_paths if os.path.exists(p)]
    if not volume_paths:
        raise RuntimeError(f"No samples found for split='{split}', cancer_type={cancer_type!r}.")
    return volume_paths


def get_pcns_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     split: str, cancer_type: Optional[Union[str, List[str]]] = None,
                     download: bool = False, **kwargs):
    """Dataset for nucleus instance segmentation over PCNS patches."""
    volume_paths = get_pcns_paths(path, split, cancer_type, download)
    return default_segmentation_dataset(
        raw_paths=volume_paths, raw_key="raw",
        label_paths=volume_paths, label_key="labels/instances",
        patch_shape=patch_shape, ndim=2, with_channels=True, **kwargs,
    )


def get_pcns_loader(path: Union[os.PathLike, str], batch_size: int,
                    patch_shape: Tuple[int, int], split: str,
                    cancer_type: Optional[Union[str, List[str]]] = None,
                    download: bool = False, **kwargs) -> DataLoader:
    """DataLoader for nucleus instance segmentation over PCNS patches."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_pcns_dataset(path, patch_shape, split, cancer_type, download, **ds_kwargs)
    return get_data_loader(ds, batch_size, **loader_kwargs)
