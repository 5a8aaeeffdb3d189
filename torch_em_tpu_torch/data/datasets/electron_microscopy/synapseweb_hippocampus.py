"""SynapseWeb hippocampus dataset: dense neuropil instance segmentation in
serial-section TEM of rat CA1 (reference
torch_em/data/datasets/electron_microscopy/synapseweb_hippocampus.py).

Publication: Harris et al. (2015), https://doi.org/10.1038/sdata.2015.46
"""

import os
from typing import Any, Dict, List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

REGIONS = ("spine", "oblique", "apical")

# bounding boxes (x0, x1, y0, y1, z0, z1) of the annotated sub-regions
ANNO_BBOXES = {
    "spine": (3072, 6144, 1536, 3840, 30, 80),
    "oblique": (512, 4608, 768, 4608, 6, 91),
    "apical": (2048, 6144, 2048, 6400, 55, 167),
}
# ROIs covering the densely annotated cube within each downloaded volume
DENSE_ROIS = {
    "spine": np.s_[0:42, 784:1665, 1007:1944],
    "oblique": np.s_[5:75, 1243:3505, 1385:3215],
    "apical": np.s_[5:106, 217:3681, 477:3936],
}


def _download_volume(region, out_path):
    h5py = _h5py()

    try:
        from cloudvolume import CloudVolume
    except ImportError:
        raise ImportError("cloudvolume is required to download the SynapseWeb data.")

    x0, x1, y0, y1, z0, z1 = ANNO_BBOXES[region]
    nx, ny, nz = x1 - x0, y1 - y0, z1 - z0
    vol_em = CloudVolume(f"s3://open-neurodata/kharris15/{region}/em", mip=0,
                         use_https=True, fill_missing=True)
    vol_anno = CloudVolume(f"s3://open-neurodata/kharris15/{region}/anno", mip=0,
                           use_https=True, fill_missing=True)
    # stream in z-slabs to bound host memory
    z_slab = 16
    with h5py.File(out_path, "w") as f:
        ds_raw = f.create_dataset("raw", shape=(nz, ny, nx), dtype="uint8", compression="gzip")
        ds_labels = f.create_dataset("labels", shape=(nz, ny, nx), dtype="uint64",
                                     compression="gzip")
        for z in range(z0, z1, z_slab):
            ze = min(z + z_slab, z1)
            slab_raw = np.array(vol_em[x0:x1, y0:y1, z:ze]).squeeze().transpose(2, 1, 0)
            slab_labels = np.array(vol_anno[x0:x1, y0:y1, z:ze]).squeeze().transpose(2, 1, 0)
            zi = z - z0
            ds_raw[zi:zi + ze - z] = slab_raw
            ds_labels[zi:zi + ze - z] = slab_labels


def get_synapseweb_hippocampus_data(path: Union[os.PathLike, str], region: str,
                                    download: bool = False):
    """Download the SynapseWeb data for a region and cache it as h5."""
    if region not in REGIONS:
        raise ValueError(f"'{region}' is not a valid region. Choose from {REGIONS}.")
    os.makedirs(path, exist_ok=True)
    out_path = os.path.join(path, f"synapseweb_hippocampus_{region}.h5")
    if os.path.exists(out_path):
        return
    if not download:
        raise RuntimeError(f"Data for region '{region}' not found at {out_path}; "
                           "pass download=True to stream it.")
    _download_volume(region, out_path)


def get_synapseweb_hippocampus_paths(path: Union[os.PathLike, str],
                                     regions: Tuple[str, ...] = REGIONS,
                                     download: bool = False) -> List[str]:
    """Get paths to the SynapseWeb volumes."""
    for region in regions:
        get_synapseweb_hippocampus_data(path, region, download)
    return [os.path.join(path, f"synapseweb_hippocampus_{r}.h5") for r in regions]


def get_synapseweb_hippocampus_dataset(path: Union[os.PathLike, str], patch_shape,
                                       regions: Tuple[str, ...] = REGIONS,
                                       rois: Dict[str, Any] = {},
                                       download: bool = False, **kwargs):
    """Get the SynapseWeb hippocampus dataset (per-region dense-annotation
    ROIs applied by default)."""
    paths = get_synapseweb_hippocampus_paths(path, regions, download)
    data_rois = [rois.get(region, DENSE_ROIS[region]) for region in regions]
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape,
                                        rois=data_rois, **kwargs)


def get_synapseweb_hippocampus_loader(path: Union[os.PathLike, str], patch_shape,
                                      batch_size: int,
                                      regions: Tuple[str, ...] = REGIONS,
                                      rois: Dict[str, Any] = {},
                                      download: bool = False, **kwargs) -> DataLoader:
    """Get the SynapseWeb hippocampus data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_synapseweb_hippocampus_dataset(path, patch_shape, regions=regions, rois=rois,
                                            download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
