"""BMGD (Breast Mammary Gland Dataset): DAPI-stained fluorescence images for
nuclei segmentation in mammary gland tissue (reference
torch_em/data/datasets/light_microscopy/bmgd.py).

819 image patches, >9,500 manually segmented nuclei, from cells cultured under
four microenvironmental stiffness conditions. Hosted at
https://github.com/zt089/Breast-Mammary-Gland-Dataset-BMGD; publication
https://doi.org/10.21203/rs.3.rs-8263420/v1.
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URLS = {
    "250pa": "https://github.com/zt089/Breast-Mammary-Gland-Dataset-BMGD/raw/main/250%20Pa.7z",
    "950pa": "https://github.com/zt089/Breast-Mammary-Gland-Dataset-BMGD/raw/main/950%20Pa.7z",
    "1200pa": "https://github.com/zt089/Breast-Mammary-Gland-Dataset-BMGD/raw/main/1200%20Pa.7z",
    "1800pa": "https://github.com/zt089/Breast-Mammary-Gland-Dataset-BMGD/raw/main/1800%20Pa.7z",
}

# folder names inside the archives (with spaces)
_FOLDER_NAMES = {"250pa": "250 Pa", "950pa": "950 Pa", "1200pa": "1200 Pa", "1800pa": "1800 Pa"}

STIFFNESS_LEVELS = list(URLS.keys())


def get_bmgd_data(path: Union[os.PathLike, str],
                  stiffness: Optional[Union[str, List[str]]] = None,
                  download: bool = False) -> str:
    """Download the BMGD archives ('250pa'/'950pa'/'1200pa'/'1800pa')."""
    if stiffness is None:
        stiffness = STIFFNESS_LEVELS
    elif isinstance(stiffness, str):
        stiffness = [stiffness]

    for s in stiffness:
        assert s in STIFFNESS_LEVELS, f"'{s}' is not valid. Choose from {STIFFNESS_LEVELS}."
        data_dir = os.path.join(str(path), _FOLDER_NAMES[s])
        if os.path.exists(data_dir) and len(glob(os.path.join(data_dir, "image", "*.tif"))) > 0:
            continue
        os.makedirs(str(path), exist_ok=True)
        archive_path = os.path.join(str(path), f"{s}.7z")
        util.download_source(path=archive_path, url=URLS[s], download=download, checksum=None)
        util.unzip(zip_path=archive_path, dst=str(path), remove=False)
    return str(path)


def _create_bmgd_h5(path, stiffness):
    """Create processed h5 files: raw + instance labels (connected components
    of the semantic mask) + the semantic mask itself."""
    h5py = _h5py()

    from ....ops.host import connected_components

    data_dir = os.path.join(str(path), _FOLDER_NAMES[stiffness])
    h5_out_dir = os.path.join(str(path), "processed", stiffness)
    os.makedirs(h5_out_dir, exist_ok=True)

    for img_path in sorted(glob(os.path.join(data_dir, "image", "*.tif"))):
        fname = os.path.basename(img_path)
        mask_path = os.path.join(data_dir, "mask", fname)
        if not os.path.exists(mask_path):
            continue
        out_path = os.path.join(h5_out_dir, f"bmgd_{stiffness}_{fname.replace('.tif', '.h5')}")
        if os.path.exists(out_path):
            continue
        raw = np.asarray(load_image(img_path))
        mask = np.asarray(load_image(mask_path))
        instances = connected_components(mask > 0).astype("int64")
        with h5py.File(out_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels/instances", data=instances, compression="gzip")
            f.create_dataset("labels/semantic", data=(mask > 0).astype("uint8"), compression="gzip")
    return h5_out_dir


def get_bmgd_paths(path: Union[os.PathLike, str],
                   stiffness: Optional[Union[str, List[str]]] = None,
                   download: bool = False) -> List[str]:
    """Paths to the processed BMGD h5 files."""
    get_bmgd_data(path, stiffness, download)
    if stiffness is None:
        stiffness = STIFFNESS_LEVELS
    elif isinstance(stiffness, str):
        stiffness = [stiffness]

    all_h5_paths = []
    for s in stiffness:
        h5_out_dir = os.path.join(str(path), "processed", s)
        if not os.path.exists(h5_out_dir) or len(glob(os.path.join(h5_out_dir, "*.h5"))) == 0:
            _create_bmgd_h5(path, s)
        all_h5_paths.extend(glob(os.path.join(h5_out_dir, "*.h5")))
    assert len(all_h5_paths) > 0, f"No data found for stiffness '{stiffness}'"
    return util.natsorted(all_h5_paths)


def get_bmgd_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     stiffness: Optional[Union[str, List[str]]] = None,
                     download: bool = False, **kwargs):
    """Dataset for nuclei segmentation in mammary gland tissue."""
    h5_paths = get_bmgd_paths(path, stiffness, download)
    kwargs, _ = util.add_instance_label_transform(kwargs, add_binary_target=True, label_dtype=np.int64)
    return default_segmentation_dataset(
        raw_paths=h5_paths, raw_key="raw",
        label_paths=h5_paths, label_key="labels/instances",
        patch_shape=patch_shape, ndim=2, **kwargs,
    )


def get_bmgd_loader(path: Union[os.PathLike, str], batch_size: int,
                    patch_shape: Tuple[int, int],
                    stiffness: Optional[Union[str, List[str]]] = None,
                    download: bool = False, **kwargs) -> DataLoader:
    """DataLoader for nuclei segmentation in mammary gland tissue."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_bmgd_dataset(path=path, patch_shape=patch_shape, stiffness=stiffness,
                          download=download, **ds_kwargs)
    return get_data_loader(dataset=ds, batch_size=batch_size, **loader_kwargs)
