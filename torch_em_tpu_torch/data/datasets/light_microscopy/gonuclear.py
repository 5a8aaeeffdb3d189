"""GoNuclear dataset: 3D nucleus and cell segmentation in Arabidopsis ovules
(reference torch_em/data/datasets/light_microscopy/gonuclear.py).

Publication: https://doi.org/10.1242/dev.202800
"""

import os
from glob import glob
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URL = ("https://www.ebi.ac.uk/biostudies/files/S-BIAD1026/Nuclei_training_segmentation/"
       "Training%20image%20dataset_Tiff%20Files.zip")
CHECKSUM = "b103388a4aed01c7aadb2d5f49392d2dd08dd7cbeb2357b0c56355384ebb93a9"


def _load_tif(path):
    for ext in (".tif", ".tiff"):
        if os.path.exists(path + ext):
            return np.asarray(load_image(path + ext))
    raise RuntimeError(f"Can't find tif or tiff file for {path}.")


def _clip_shape(raw, labels):
    shape = tuple(min(r, l) for r, l in zip(raw.shape, labels.shape))
    return raw[:shape[0], :shape[1], :shape[2]], labels[:shape[0], :shape[1], :shape[2]]


def _process_sample_folders(in_folder, out_folder):
    h5py = _h5py()

    os.makedirs(out_folder, exist_ok=True)
    for folder in sorted(glob(os.path.join(in_folder, "*"))):
        sample = os.path.basename(folder)
        cell_raw = _load_tif(os.path.join(folder, f"{sample}_cellwall"))
        cell_labels = _load_tif(os.path.join(folder, f"{sample}_cellseg"))[:, ::-1]
        cell_raw, cell_labels = _clip_shape(cell_raw, cell_labels)

        nucleus_raw = _load_tif(os.path.join(folder, f"{sample}_n_H2BtdTomato"))
        nucleus_labels = _load_tif(os.path.join(folder, f"{sample}_n_stain_StarDist_goldGT"))[:, ::-1]
        nucleus_raw, nucleus_labels = _clip_shape(nucleus_raw, nucleus_labels)

        # two volumes have a last frame with artifacts; one has misaligned cell labels
        if sample in ("1137", "1170"):
            nucleus_raw, nucleus_labels = nucleus_raw[:-1], nucleus_labels[:-1]
            cell_raw, cell_labels = cell_raw[:-1], cell_labels[:-1]
        if sample == "1136":
            cell_labels = np.fliplr(cell_labels)

        with h5py.File(os.path.join(out_folder, f"{sample}.h5"), "w") as f:
            f.create_dataset("raw/cells", data=cell_raw, compression="gzip")
            f.create_dataset("raw/nuclei", data=nucleus_raw, compression="gzip")
            f.create_dataset("labels/cells", data=cell_labels, compression="gzip")
            f.create_dataset("labels/nuclei", data=nucleus_labels, compression="gzip")


def get_gonuclear_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and convert the GoNuclear data."""
    data_folder = os.path.join(path, "gonuclear_datasets")
    if os.path.exists(data_folder):
        return data_folder
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "gonuclear.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    extracted = os.path.join(path, "Training image dataset_Tiff Files")
    assert os.path.exists(extracted), extracted
    _process_sample_folders(extracted, data_folder)
    return data_folder


def get_gonuclear_paths(path: Union[os.PathLike, str],
                        sample_ids: Optional[Sequence[Union[int, str]]] = None,
                        download: bool = False) -> List[str]:
    """Get paths to the GoNuclear volumes."""
    data_root = get_gonuclear_data(path, download)
    if sample_ids is None:
        return sorted(glob(os.path.join(data_root, "*.h5")))
    paths = []
    for sample_id in sample_ids:
        sample_path = os.path.join(data_root, f"{sample_id}.h5")
        if not os.path.exists(sample_path):
            raise ValueError(f"Invalid sample id {sample_id}.")
        paths.append(sample_path)
    return paths


def get_gonuclear_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                          segmentation_task: str = "nuclei",
                          sample_ids: Optional[Sequence[Union[int, str]]] = None,
                          offsets=None, boundaries: bool = False, binary: bool = False,
                          download: bool = False, **kwargs):
    """Get the GoNuclear dataset for nucleus ('nuclei') or cell ('cells')
    segmentation."""
    paths = get_gonuclear_paths(path, sample_ids, download)
    if segmentation_task == "nuclei":
        raw_key, label_key = "raw/nuclei", "labels/nuclei"
    elif segmentation_task == "cells":
        raw_key, label_key = "raw/cells", "labels/cells"
    else:
        raise ValueError(f"Invalid segmentation task {segmentation_task}.")
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries, offsets=offsets,
    )
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, raw_key, paths, label_key, patch_shape, **kwargs)


def get_gonuclear_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                         batch_size: int, segmentation_task: str = "nuclei",
                         sample_ids: Optional[Sequence[Union[int, str]]] = None,
                         offsets=None, boundaries: bool = False, binary: bool = False,
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the GoNuclear data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_gonuclear_dataset(
        path, patch_shape, segmentation_task=segmentation_task, sample_ids=sample_ids,
        offsets=offsets, boundaries=boundaries, binary=binary, download=download, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
