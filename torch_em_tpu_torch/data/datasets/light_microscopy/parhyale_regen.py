"""Parhyale Regen dataset: nucleus segmentation in regenerating Parhyale
limbs (H2B-EGFP light-sheet timepoints) (reference
torch_em/data/datasets/light_microscopy/parhyale_regen.py).

Located at https://zenodo.org/records/8252039.
"""

import os
from glob import glob
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

RECORD_API = "https://zenodo.org/api/records/8252039"


def _preprocess_data(root, path):
    h5py = _h5py()

    raw_path = os.path.join(path, "Parhyale_H2B-EGFP_images_tp01-50.tif")
    assert os.path.exists(raw_path)
    # the raw stack is a 4D ImageJ hyperstack over 50 timepoints (tp, z, y, x);
    # reference parhyale_regen.py:28 reads it with imageio. load_image reads its
    # pages one by one through PIL, flattened as (tp * z, y, x), so restore the
    # timepoint axis from the known count.
    raw = np.asarray(load_image(raw_path))
    n_tps = 50
    if raw.ndim == 3 and raw.shape[0] != n_tps and raw.shape[0] % n_tps == 0:
        raw = raw.reshape(n_tps, raw.shape[0] // n_tps, *raw.shape[1:])
    tps = [0, 10, 20, 30, 40, 49]
    label_tps = [np.asarray(load_image(p)) for p in util.natsorted(
        glob(os.path.join(path, "*_instance-segmentation-labels_*.tif")))]
    new_path = os.path.join(root, "preprocessed")
    os.makedirs(new_path, exist_ok=True)
    for curr_tp, curr_label in zip(tps, label_tps):
        fpath = os.path.join(new_path, f"Parhyale_H2B-EGFP_{curr_tp + 1}.h5")
        if os.path.exists(fpath):
            continue
        with h5py.File(fpath, "w") as f:
            f.create_dataset("raw", data=raw[curr_tp], compression="gzip")
            f.create_dataset("labels", data=curr_label, compression="gzip")


def get_parhyale_regen_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download (via the zenodo record listing) and preprocess the data."""
    import requests

    data_dir = os.path.join(path, "data")
    if os.path.exists(os.path.join(path, "preprocessed")):
        return path
    if not os.path.exists(data_dir):
        if not download:
            raise RuntimeError("Cannot find the data; use download=True to fetch it.")
        os.makedirs(data_dir, exist_ok=True)
        for f in requests.get(RECORD_API).json()["files"]:
            fpath = os.path.join(data_dir, f["key"])
            if os.path.exists(fpath):
                continue
            r = requests.get(f["links"]["self"])
            with open(fpath, "wb") as out:
                out.write(r.content)
    _preprocess_data(path, data_dir)
    return path


def get_parhyale_regen_paths(path: Union[os.PathLike, str],
                             download: bool = False) -> List[str]:
    """Get paths to the preprocessed Parhyale volumes."""
    get_parhyale_regen_data(path, download)
    return util.natsorted(glob(os.path.join(path, "preprocessed", "*.h5")))


def get_parhyale_regen_dataset(path: Union[os.PathLike, str], patch_shape,
                               download: bool = False, **kwargs):
    """Get the Parhyale Regen dataset for nucleus segmentation."""
    paths = get_parhyale_regen_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape, **kwargs)


def get_parhyale_regen_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                              download: bool = False, **kwargs) -> DataLoader:
    """Get the Parhyale Regen data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_parhyale_regen_dataset(path, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
