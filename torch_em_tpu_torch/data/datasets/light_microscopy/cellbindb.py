"""CellBinDB dataset: cell segmentation across DAPI / HE / mIF / ssDNA
stainings (reference torch_em/data/datasets/light_microscopy/cellbindb.py).

Hosted at https://db.cngb.org/search/project/CNP0006370/ (ftp mirror;
downloading takes several hours).
"""

import os
import subprocess
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image
from .. import util

DOWNLOAD_SCRIPT = ('wget -c -nH -np -r -R "index.html*" --cut-dirs 4 '
                   "ftp://ftp.cngb.org/pub/CNSA/data5/CNP0006370/Other/")
CHOICES = ("10×Genomics_DAPI", "10×Genomics_HE", "DAPI", "HE", "mIF", "ssDNA")


def get_cellbindb_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the CellBinDB data (very slow ftp mirror)."""
    data_dir = os.path.join(path, "Other")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    if not download:
        raise AssertionError("The dataset is not found and download is set to 'False'.")
    print("Downloading CellBinDB takes several hours; ensure a stable connection.")
    parts = DOWNLOAD_SCRIPT.split(" ")
    subprocess.run([*parts[:-1], "-P", os.path.abspath(path), parts[-1]])
    return data_dir


def _is_valid_image(im_path):
    Image = _pil_image()
    try:
        with Image.open(im_path) as im:
            im.load()
        return True
    except Exception:
        return False


def get_cellbindb_paths(path: Union[os.PathLike, str],
                        data_choice: Optional[Union[str, List[str]]] = None,
                        download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the CellBinDB images and instance masks."""
    data_dir = get_cellbindb_data(path, download)
    if data_choice is None:
        data_choice = CHOICES
    elif isinstance(data_choice, str):
        data_choice = [data_choice]
    raw_paths, label_paths = [], []
    for dchoice in data_choice:
        assert dchoice in CHOICES, f"'{dchoice}' is not a valid data choice."
        raw_paths.extend(util.natsorted(glob(
            os.path.join(data_dir, dchoice, "*", "*-img.tif"))))
        label_paths.extend(util.natsorted(glob(
            os.path.join(data_dir, dchoice, "*", "*-instancemask.tif"))))
    # a few files are corrupted at the source; drop those pairs.
    valid = [(rp, lp) for rp, lp in zip(raw_paths, label_paths)
             if _is_valid_image(rp) and _is_valid_image(lp)]
    raw_paths = [v[0] for v in valid]
    label_paths = [v[1] for v in valid]
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_cellbindb_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          data_choice: Optional[Union[str, List[str]]] = None,
                          download: bool = False, **kwargs):
    """Get the CellBinDB dataset for cell segmentation."""
    raw_paths, label_paths = get_cellbindb_paths(path, data_choice, download)
    return default_segmentation_dataset(
        raw_paths, None, label_paths, None, patch_shape,
        is_seg_dataset=False, ndim=2, **kwargs,
    )


def get_cellbindb_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         batch_size: int,
                         data_choice: Optional[Union[str, List[str]]] = None,
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the CellBinDB data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_cellbindb_dataset(path, patch_shape, data_choice=data_choice,
                               download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
