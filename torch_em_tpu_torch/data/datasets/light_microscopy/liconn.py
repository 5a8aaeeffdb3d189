"""LICONN dataset: dense connectomic reconstruction of mouse hippocampal CA1
neuropil from expansion-microscopy confocal imaging (~16x expansion, 9x9x12 nm
native voxels), with dense instance annotations of axons, dendrites and spines
(reference torch_em/data/datasets/light_microscopy/liconn.py).

Two segmentation variants: 'proofread' (manually proofread) and 'agglomerated'
(automatic). Served as Neuroglancer precomputed volumes from GCS
(gs://liconn-public); streaming requires the optional ``cloud-volume``
package. Volumes are cached locally as h5 with keys 'raw', 'seg_proofread',
'seg_agglomerated' (the reference caches one sharded zarr-v3 store, same keys).
Publication: Velicky et al. 2025, https://doi.org/10.1038/s41586-025-08985-1.
"""

import os
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

IMG_URL = "precomputed://https://storage.googleapis.com/liconn-public/ExPID82_1/image_230130b"
SEG_PR_URL = "precomputed://https://storage.googleapis.com/liconn-public/ExPID82_1/segmentation/231030_agg_240123"
SEG_AGG_URL = "precomputed://https://storage.googleapis.com/liconn-public/ExPID82_1/segmentation/231030_agg_230921_cmpl"  # noqa

SEGMENTATIONS = ("proofread", "agglomerated")
CACHE_FNAME = "liconn.h5"


def _to_zyx(a: np.ndarray) -> np.ndarray:
    # CloudVolume returns (X, Y, Z[, C]); squeeze trailing channel, go to (z, y, x)
    if a.ndim == 4:
        a = a.squeeze(axis=-1)
    if a.ndim != 3:
        raise ValueError(f"Expected 3D block, got shape {a.shape}")
    return a.transpose(2, 1, 0)


def _fetch_full(cv) -> np.ndarray:
    x0, y0, z0 = map(int, cv.bounds.minpt)
    x1, y1, z1 = map(int, cv.bounds.maxpt)
    return _to_zyx(np.asarray(cv[x0:x1, y0:y1, z0:z1]))


def get_liconn_data(path: Union[os.PathLike, str], segmentation: str = "proofread",
                    download: bool = False) -> str:
    """Stream the LICONN raw volume + one segmentation variant and cache as h5."""
    h5py = _h5py()

    assert segmentation in SEGMENTATIONS, \
        f"Invalid segmentation '{segmentation}'. Choose from {SEGMENTATIONS}."
    os.makedirs(str(path), exist_ok=True)
    h5_path = os.path.join(str(path), CACHE_FNAME)
    label_key = f"seg_{segmentation}"

    def have(key):
        if not os.path.exists(h5_path):
            return False
        with h5py.File(h5_path, "r") as f:
            return key in f

    if have("raw") and have(label_key):
        return h5_path
    if not download:
        missing = [k for k in ("raw", label_key) if not have(k)]
        raise RuntimeError(f"Missing arrays {missing} in '{h5_path}'; set download=True to stream them.")
    try:
        from cloudvolume import CloudVolume
    except ImportError:
        raise ImportError("The 'cloud-volume' package is required to stream the LICONN data.")

    with h5py.File(h5_path, "a") as f:
        if "raw" not in f:
            raw_cv = CloudVolume(IMG_URL, use_https=True, mip=0, progress=True, fill_missing=True)
            f.create_dataset("raw", data=_fetch_full(raw_cv), compression="gzip", chunks=True)
        if label_key not in f:
            seg_url = SEG_PR_URL if segmentation == "proofread" else SEG_AGG_URL
            seg_cv = CloudVolume(seg_url, use_https=True, mip=0, progress=True, fill_missing=True)
            f.create_dataset(label_key, data=_fetch_full(seg_cv), compression="gzip", chunks=True)
    return h5_path


def get_liconn_paths(path: Union[os.PathLike, str], segmentation: str = "proofread",
                     download: bool = False) -> List[str]:
    """Path to the cached LICONN store."""
    return [get_liconn_data(path, segmentation, download)]


def get_liconn_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                       segmentation: str = "proofread", download: bool = False, **kwargs):
    """Dataset for dense neuropil instance segmentation in LICONN."""
    assert segmentation in SEGMENTATIONS
    paths = get_liconn_paths(path, segmentation, download)
    return default_segmentation_dataset(
        raw_paths=paths, raw_key="raw",
        label_paths=paths, label_key=f"seg_{segmentation}",
        patch_shape=patch_shape, is_seg_dataset=True, **kwargs,
    )


def get_liconn_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                      batch_size: int, segmentation: str = "proofread",
                      download: bool = False, **kwargs) -> DataLoader:
    """DataLoader for dense neuropil instance segmentation in LICONN."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_liconn_dataset(path, patch_shape, segmentation, download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
