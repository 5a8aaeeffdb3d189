"""PANORAMA dataset: pancreatic lesion (PDAC) segmentation in contrast CT
(reference torch_em/data/datasets/medical/panorama.py).

Volumes come from the PANORAMA challenge zenodo batches; labels from
https://github.com/DIAGNijmegen/panorama_labels.
"""

import os
import shutil
import subprocess
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URLS = {
    "batch_1": "https://zenodo.org/records/13715870/files/batch_1.zip",
    "batch_2": "https://zenodo.org/records/13742336/files/batch_2.zip",
    "batch_3": "https://zenodo.org/records/11034011/files/batch_3.zip",
    "batch_4": "https://zenodo.org/records/10999754/files/batch_4.zip",
}
CHECKSUMS = {
    "batch_1": "aff39b6347650d6c7457adf7a04bfb0a651ab6ecd33676ff109bdab17bc41cff",
    "batch_2": "db6353a2c1c565c8bf084bd4fe1512fd6020b7675a1c9ab61b9a13d72a9fe76c",
    "batch_3": "c1d71b40948edc36f795a7801cc79000082df8d365c48574af50b36516d64cee",
    "batch_4": "3b5341af79c2cc8b8a9fa3ab7a6cfa8fedf694538a3d6be97c18e5c82be4d9d8",
}


def get_panorama_data(path: Union[os.PathLike, str], download: bool = False):
    """Download the PANORAMA volumes and labels (large download)."""
    data_path = os.path.join(path, "volumes")
    label_path = os.path.join(path, "labels")
    if os.path.exists(data_path) and os.path.exists(label_path):
        return
    os.makedirs(path, exist_ok=True)
    if not download:
        raise RuntimeError("The dataset is not found and download is set to False.")
    subprocess.call(["git", "clone", "--quiet",
                     "https://github.com/DIAGNijmegen/panorama_labels", label_path])
    for batch, url in URLS.items():
        zip_path = os.path.join(path, f"{batch}.zip")
        util.download_source(zip_path, url, download, CHECKSUMS[batch])
        util.unzip(zip_path, data_path)
        # batches 3/4 unpack into a sub-folder; flatten them.
        batch_dir = os.path.join(data_path, batch)
        if os.path.exists(batch_dir):
            for fpath in glob(os.path.join(batch_dir, "*.nii.gz")):
                shutil.move(fpath, data_path)
            shutil.rmtree(batch_dir)


def get_panorama_paths(path: Union[os.PathLike, str],
                       annotation_choice: Optional[str] = None,
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the PANORAMA volumes and ('manual' or 'automatic') labels."""
    get_panorama_data(path, download)
    if annotation_choice is None:
        annotation_choice = "*"
    label_paths = util.natsorted(glob(
        os.path.join(path, "labels", f"{annotation_choice}_labels", "*.nii.gz")))
    raw_dir = os.path.join(path, "volumes")
    raw_paths = [os.path.join(raw_dir, os.path.basename(p).replace(".nii.gz", "_0000.nii.gz"))
                 for p in label_paths]
    # the label '100051_00001.nii.gz' ships as an empty file upstream; drop it.
    keep = [i for i, p in enumerate(label_paths)
            if os.path.basename(p) != "100051_00001.nii.gz" and os.path.exists(raw_paths[i])]
    raw_paths = [raw_paths[i] for i in keep]
    label_paths = [label_paths[i] for i in keep]
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_panorama_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                         annotation_choice: Optional[str] = None,
                         download: bool = False, **kwargs):
    """Get the PANORAMA dataset for pancreatic lesion segmentation."""
    raw_paths, label_paths = get_panorama_paths(path, annotation_choice, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None,
                                        patch_shape, **kwargs)


def get_panorama_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                        batch_size: int, annotation_choice: Optional[str] = None,
                        download: bool = False, **kwargs) -> DataLoader:
    """Get the PANORAMA data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_panorama_dataset(path, patch_shape, annotation_choice=annotation_choice,
                              download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
