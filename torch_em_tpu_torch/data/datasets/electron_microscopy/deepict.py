"""DeePiCt actin dataset: actin segmentation in cryo-electron tomography
(reference torch_em/data/datasets/electron_microscopy/deepict.py).

Data from the cryo-ET data portal (dataset 10002);
publication: https://doi.org/10.1038/s41592-022-01746-2
"""

import os
from glob import glob
from shutil import rmtree
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_data
from ....utils.medical_io import load_mrc
from .. import util

ACTIN_ID = 10002


def _process_deepict_actin(input_path, output_path):
    h5py = _h5py()

    os.makedirs(output_path, exist_ok=True)
    # dataset 00011 has known issues and is skipped (as in the reference)
    for dataset in ("00004", "00012"):
        ds_folder = os.path.join(input_path, dataset)
        assert os.path.exists(ds_folder), ds_folder
        ds_out = os.path.join(output_path, f"{dataset}.h5")
        if os.path.exists(ds_out):
            continue

        tomo_folder = glob(os.path.join(ds_folder, "Tomograms", "VoxelSpacing*"))
        assert len(tomo_folder) == 1
        tomo_folder = tomo_folder[0]

        data = np.asarray(load_mrc(
            os.path.join(tomo_folder, "CanonicalTomogram", f"{dataset}.mrc")))

        annotations = {}
        for annotation in glob(os.path.join(tomo_folder, "Annotations", "*.zarr")):
            annotation_data = np.asarray(load_data(annotation, "0")[:]).astype("uint8")
            assert annotation_data.shape == data.shape
            annotations[os.path.basename(annotation).split("-")[1]] = annotation_data

        with h5py.File(ds_out, "a") as f:
            f.create_dataset("raw", data=data, compression="gzip")
            for name, annotation in annotations.items():
                f.create_dataset(f"labels/original/{name}", data=annotation, compression="gzip")
            # combined actin annotation: training prediction + ground truth
            actin_seg = annotations["actin_deepict_training_prediction"]
            actin_seg[annotations["actin_ground_truth"] == 1] = 1
            f.create_dataset("labels/actin", data=actin_seg, compression="gzip")


def get_deepict_actin_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and process the DeePiCt actin data."""
    dataset_path = os.path.join(path, "deepict_actin")
    if os.path.exists(dataset_path):
        return dataset_path
    dl_path = util.download_from_cryo_et_portal(path, ACTIN_ID, download)
    _process_deepict_actin(dl_path, dataset_path)
    rmtree(dl_path)
    return dataset_path


def get_deepict_actin_paths(path: Union[os.PathLike, str],
                            download: bool = False) -> List[str]:
    """Get paths to the DeePiCt actin volumes."""
    get_deepict_actin_data(path, download)
    return sorted(glob(os.path.join(path, "deepict_actin", "*.h5")))


def get_deepict_actin_dataset(path: Union[os.PathLike, str], patch_shape,
                              label_key: str = "labels/actin",
                              download: bool = False, **kwargs):
    """Get the DeePiCt dataset for actin segmentation."""
    paths = get_deepict_actin_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, label_key, patch_shape, **kwargs)


def get_deepict_actin_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                             label_key: str = "labels/actin", download: bool = False,
                             **kwargs) -> DataLoader:
    """Get the DeePiCt actin data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_deepict_actin_dataset(path, patch_shape, label_key=label_key,
                                   download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
