"""SLiMIA dataset: spheroid segmentation across nine brightfield microscopes
(reference torch_em/data/datasets/light_microscopy/slimia.py).

The Spheroid Light Microscopy Image Atlas, hosted on figshare
(https://doi.org/10.1038/s41597-025-04441-x). Image/mask tiff pairs are
converted to h5 with 'raw' and binary 'labels'.
"""

import os
from glob import glob
from typing import List, Optional, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URLS = {
    "OperaPhenix": "https://ndownloader.figshare.com/files/50120850",
    "OlympusIX05": "https://ndownloader.figshare.com/files/50120853",
    "Axiovert200M": "https://ndownloader.figshare.com/files/50122224",
    "Cytation5": "https://ndownloader.figshare.com/files/50122194",
    "LeicaDMi3000B": "https://ndownloader.figshare.com/files/50122473",
    "Axiovert200": "https://ndownloader.figshare.com/files/50134212",
    "IncucyteS3": "https://ndownloader.figshare.com/files/50134218",
    "LeicaDMi1": "https://ndownloader.figshare.com/files/50134776",
    "IncucyteZOOM": "https://ndownloader.figshare.com/files/50136054",
}
MICROSCOPES = list(URLS.keys())


def _to_microscopes(microscope):
    if microscope is None:
        return MICROSCOPES
    if isinstance(microscope, str):
        microscope = [microscope]
    invalid = set(microscope) - set(URLS)
    if invalid:
        raise ValueError(f"Invalid microscope choices: {sorted(invalid)}.")
    return microscope


def _create_h5_data(path, microscope):
    h5py = _h5py()

    h5_dir = os.path.join(path, "h5_data", microscope)
    os.makedirs(h5_dir, exist_ok=True)
    image_dir = os.path.join(path, microscope, "Images")
    seg_dir = os.path.join(path, microscope, "Manual segmentations")
    for cell_line in sorted(os.listdir(image_dir)):
        cl_image_dir = os.path.join(image_dir, cell_line)
        cl_seg_dir = os.path.join(seg_dir, cell_line)
        if not os.path.isdir(cl_image_dir) or not os.path.isdir(cl_seg_dir):
            continue
        for image_path in sorted(glob(os.path.join(cl_image_dir, "*.tiff"))):
            base_name = os.path.basename(image_path).replace(".ome.tiff", "").replace(".tiff", "")
            h5_path = os.path.join(h5_dir, f"{base_name}.h5")
            if os.path.exists(h5_path):
                continue
            seg_path = os.path.join(cl_seg_dir, f"{base_name}.tiff")
            if not os.path.exists(seg_path):
                seg_path = os.path.join(cl_seg_dir, f"{base_name}.ome.tiff")
            if not os.path.exists(seg_path):
                continue
            raw = np.asarray(load_image(image_path))
            labels = (np.asarray(load_image(seg_path)) > 0).astype("int64")
            with h5py.File(h5_path, "w") as f:
                f.create_dataset("raw", data=raw, compression="gzip")
                f.create_dataset("labels", data=labels, compression="gzip")
    return h5_dir


def get_slimia_data(path: Union[os.PathLike, str],
                    microscope: Optional[Union[str, List[str]]] = None,
                    download: bool = False) -> str:
    """Download the SLiMIA data for the chosen microscopes."""
    os.makedirs(path, exist_ok=True)
    for micro in _to_microscopes(microscope):
        if os.path.exists(os.path.join(path, micro)):
            continue
        zip_path = os.path.join(path, f"{micro}.zip")
        util.download_source(zip_path, URLS[micro], download)
        util.unzip(zip_path, path)
    return path


def get_slimia_paths(path: Union[os.PathLike, str],
                     microscope: Optional[Union[str, List[str]]] = None,
                     download: bool = False) -> List[str]:
    """Get paths to the preprocessed SLiMIA h5 files."""
    get_slimia_data(path, microscope, download)
    all_h5_paths = []
    for micro in _to_microscopes(microscope):
        h5_dir = os.path.join(path, "h5_data", micro)
        if not os.path.exists(h5_dir) or len(glob(os.path.join(h5_dir, "*.h5"))) == 0:
            h5_dir = _create_h5_data(path, micro)
        all_h5_paths.extend(glob(os.path.join(h5_dir, "*.h5")))
    return util.natsorted(all_h5_paths)


def get_slimia_dataset(path: Union[os.PathLike, str], patch_shape,
                       microscope: Optional[Union[str, List[str]]] = None,
                       download: bool = False, **kwargs):
    """Get the SLiMIA dataset for spheroid segmentation."""
    volume_paths = get_slimia_paths(path, microscope, download)
    return default_segmentation_dataset(
        volume_paths, "raw", volume_paths, "labels", patch_shape,
        is_seg_dataset=True, ndim=2, **kwargs,
    )


def get_slimia_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                      microscope: Optional[Union[str, List[str]]] = None,
                      download: bool = False, **kwargs) -> DataLoader:
    """Get the SLiMIA data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_slimia_dataset(path, patch_shape, microscope=microscope,
                            download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
