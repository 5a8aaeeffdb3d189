"""Male CNS Connectome dataset: full FIB-SEM volume of the Drosophila male
central nervous system with dense neuron instance segmentation (reference
torch_em/data/datasets/electron_microscopy/malecns.py).

Hosted at https://male-cns.janelia.org via Google Cloud Storage; described in
https://www.biorxiv.org/content/10.1101/2025.10.09.680999v2. The full volume
is ~1 PB, so data is accessed by bounding box (8 nm voxel coordinates),
streamed with the optional ``cloud-volume`` package and cached as h5.
"""

import hashlib
import os
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

EM_URL = "gs://flyem-male-cns/em/em-clahe-jpeg"
SEG_URL = "gs://flyem-male-cns/v0.9/segmentation"

# A representative 1024^3 subvolume near the centre of the well-reconstructed
# region; (x_min, x_max, y_min, y_max, z_min, z_max) in 8 nm voxels.
DEFAULT_BOUNDING_BOX = (40000, 41024, 40000, 41024, 20000, 21024)


def _bbox_to_str(bbox):
    return hashlib.md5("_".join(str(v) for v in bbox).encode()).hexdigest()[:12]


def get_malecns_data(path: Union[os.PathLike, str],
                     bounding_box: Tuple[int, ...] = DEFAULT_BOUNDING_BOX,
                     download: bool = False) -> str:
    """Stream a Male CNS subvolume (EM + segmentation) from GCS and cache as h5."""
    h5py = _h5py()

    os.makedirs(str(path), exist_ok=True)
    h5_path = os.path.join(str(path), f"{_bbox_to_str(bounding_box)}.h5")
    if os.path.exists(h5_path):
        return h5_path
    if not download:
        raise RuntimeError(f"No cached data found at '{h5_path}'. Set download=True to stream it from GCS.")
    try:
        import cloudvolume
    except ImportError:
        raise ImportError("The 'cloud-volume' package is required to access the Male CNS dataset.")

    x_min, x_max, y_min, y_max, z_min, z_max = bounding_box
    em_vol = cloudvolume.CloudVolume(EM_URL, use_https=True, mip=0, progress=True)
    seg_vol = cloudvolume.CloudVolume(SEG_URL, use_https=True, mip=0, progress=True)

    # cloud-volume returns (x, y, z, 1); squeeze channel, transpose to (z, y, x)
    raw = np.array(em_vol[x_min:x_max, y_min:y_max, z_min:z_max])[..., 0].transpose(2, 1, 0)
    labels = np.array(seg_vol[x_min:x_max, y_min:y_max, z_min:z_max])[..., 0].transpose(2, 1, 0)

    with h5py.File(h5_path, "w") as f:
        f.attrs["bounding_box"] = bounding_box
        f.attrs["crop_size"] = raw.shape
        f.attrs["resolution_nm"] = em_vol.resolution.tolist()
        f.create_dataset("raw", data=raw.astype("uint8"), compression="gzip", chunks=True)
        f.create_dataset("labels", data=labels.astype("uint64"), compression="gzip", chunks=True)
    return h5_path


def get_malecns_paths(path: Union[os.PathLike, str],
                      bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                      download: bool = False) -> List[str]:
    """Get paths to cached Male CNS h5 files, one per bounding box."""
    if bounding_boxes is None:
        bounding_boxes = [DEFAULT_BOUNDING_BOX]
    return [get_malecns_data(path, bbox, download) for bbox in bounding_boxes]


def get_malecns_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                        bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                        download: bool = False, **kwargs):
    """Dataset for neuron instance segmentation in the Male CNS volume."""
    paths = get_malecns_paths(path, bounding_boxes, download)
    return default_segmentation_dataset(
        raw_paths=paths, raw_key="raw",
        label_paths=paths, label_key="labels",
        patch_shape=patch_shape, is_seg_dataset=True, **kwargs,
    )


def get_malecns_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                       batch_size: int,
                       bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                       download: bool = False, **kwargs) -> DataLoader:
    """DataLoader for neuron instance segmentation in the Male CNS volume."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_malecns_dataset(path, patch_shape, bounding_boxes, download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
