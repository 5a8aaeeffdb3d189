"""MorphoNet dataset: 3D cell/nucleus instance segmentation across five model
organisms imaged with confocal and light-sheet microscopy (reference
torch_em/data/datasets/light_microscopy/morphonet.py).

Organisms: Patiria miniata, Tribolium castaneum, Arabidopsis thaliana,
Caenorhabditis elegans, Phallusia mammillata. Data at
https://doi.org/10.6084/m9.figshare.30529745.v2; publication
https://doi.org/10.7554/eLife.106227.2.
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
    "patiria_miniata": "https://ndownloader.figshare.com/files/59296676",
    "tribolium_castaneum": "https://ndownloader.figshare.com/files/59296685",
    "arabidopsis_thaliana": "https://ndownloader.figshare.com/files/59296700",
    "caenorhabditis_elegans": "https://ndownloader.figshare.com/files/59296703",
    "phallusia_mammillata": "https://ndownloader.figshare.com/files/59296712",
}

DIR_NAMES = {
    "patiria_miniata": "Patiria miniata",
    "tribolium_castaneum": "Tribolium castaneum",
    "arabidopsis_thaliana": "Arabidopsis thaliana",
    "caenorhabditis_elegans": "Caenorhabditis elegans",
    "phallusia_mammillata": "Phallusia mammillata",
}

ORGANISMS = list(URLS.keys())


def _get_tif_files(directory):
    files = glob(os.path.join(directory, "*.tif")) + glob(os.path.join(directory, "*.tiff"))
    return [f for f in files if not os.path.basename(f).startswith(".")]  # skip macOS metadata


def _match_raw_seg_files(raw_dir, seg_dir, organism):
    raw_files = util.natsorted(_get_tif_files(raw_dir))
    seg_files = util.natsorted(_get_tif_files(seg_dir))
    # For Tribolium, filter out the empty channel 0 from RAW (only ch1 has nuclei).
    if organism == "tribolium_castaneum":
        raw_files = [f for f in raw_files if "ch0" not in os.path.basename(f)]
    assert len(raw_files) > 0, f"No RAW files found in {raw_dir}"
    assert len(seg_files) > 0, f"No SEG files found in {seg_dir}"
    assert len(raw_files) == len(seg_files), \
        f"Mismatch for {organism}: {len(raw_files)} RAW files vs {len(seg_files)} SEG files"
    return list(zip(raw_files, seg_files))


def _create_h5_data(path, organism):
    h5py = _h5py()

    h5_dir = os.path.join(str(path), "h5_data", organism)
    os.makedirs(h5_dir, exist_ok=True)
    org_dir = os.path.join(str(path), DIR_NAMES[organism])
    pairs = _match_raw_seg_files(os.path.join(org_dir, "published", "RAW"),
                                 os.path.join(org_dir, "published", "SEG"), organism)
    for i, (raw_path, seg_path) in enumerate(pairs):
        h5_path = os.path.join(h5_dir, f"t{i:04d}.h5")
        if os.path.exists(h5_path):
            continue
        raw = np.asarray(load_image(raw_path))
        seg = np.asarray(load_image(seg_path))
        with h5py.File(h5_path, "w") as f:
            f.create_dataset("raw", data=raw, compression="gzip")
            f.create_dataset("labels", data=seg.astype("int64"), compression="gzip")
    return h5_dir


def get_morphonet_data(path: Union[os.PathLike, str],
                       organism: Optional[Union[str, List[str]]] = None,
                       download: bool = False) -> str:
    """Download the MorphoNet archives (all organisms if None)."""
    if organism is None:
        organism = ORGANISMS
    elif isinstance(organism, str):
        organism = [organism]
    for org in organism:
        assert org in ORGANISMS, f"'{org}' is not a valid organism. Choose from {ORGANISMS}."
        org_dir = os.path.join(str(path), DIR_NAMES[org])
        if os.path.exists(org_dir):
            continue
        os.makedirs(str(path), exist_ok=True)
        zip_path = os.path.join(str(path), f"{org}.zip")
        util.download_source(path=zip_path, url=URLS[org], download=download, checksum=None)
        util.unzip(zip_path=zip_path, dst=str(path))
    return str(path)


def get_morphonet_paths(path: Union[os.PathLike, str],
                        organism: Optional[Union[str, List[str]]] = None,
                        download: bool = False) -> List[str]:
    """Paths to the processed MorphoNet h5 files."""
    if organism is None:
        organism = ORGANISMS
    elif isinstance(organism, str):
        organism = [organism]
    get_morphonet_data(path, organism, download)

    all_h5_paths = []
    for org in organism:
        h5_dir = os.path.join(str(path), "h5_data", org)
        if not os.path.exists(h5_dir) or len(glob(os.path.join(h5_dir, "*.h5"))) == 0:
            _create_h5_data(path, org)
        all_h5_paths.extend(glob(os.path.join(h5_dir, "*.h5")))
    assert len(all_h5_paths) > 0, f"No data found for organism(s) '{organism}'"
    return util.natsorted(all_h5_paths)


def get_morphonet_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                          organism: Optional[Union[str, List[str]]] = None,
                          download: bool = False, **kwargs):
    """Dataset for 3D cell/nucleus instance segmentation across organisms."""
    h5_paths = get_morphonet_paths(path, organism, download)
    return default_segmentation_dataset(
        raw_paths=h5_paths, raw_key="raw",
        label_paths=h5_paths, label_key="labels",
        patch_shape=patch_shape, ndim=3, **kwargs,
    )


def get_morphonet_loader(path: Union[os.PathLike, str], batch_size: int,
                         patch_shape: Tuple[int, int, int],
                         organism: Optional[Union[str, List[str]]] = None,
                         download: bool = False, **kwargs) -> DataLoader:
    """DataLoader for 3D cell/nucleus instance segmentation across organisms."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_morphonet_dataset(path, patch_shape, organism, download, **ds_kwargs)
    return get_data_loader(ds, batch_size, **loader_kwargs)
