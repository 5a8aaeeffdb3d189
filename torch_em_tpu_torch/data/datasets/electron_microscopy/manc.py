"""MANC dataset: neuron segmentation in the male adult nerve cord EM volume
(reference torch_em/data/datasets/electron_microscopy/manc.py).

Streams subvolumes from the public Janelia FlyEM buckets (requires the
optional cloud-volume package); publication: https://doi.org/10.7554/eLife.89346
"""

import hashlib
import os
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

EM_URL = "gs://flyem-vnc-2-26-213dba213ef26e094c16c860ae7f4be0/v3_emdata_clahe_xy/jpeg"
SEG_URL = "gs://manc-seg-v1p2/manc-seg-v1.2"

# central 1024^3 training region in 8 nm voxel coordinates
DEFAULT_BOUNDING_BOX = (20000, 21024, 25000, 26024, 40000, 41024)


def _bbox_to_str(bbox):
    return hashlib.md5("_".join(str(v) for v in bbox).encode()).hexdigest()[:12]


def get_manc_data(path: Union[os.PathLike, str],
                  bounding_box: Tuple[int, ...] = DEFAULT_BOUNDING_BOX,
                  download: bool = False) -> str:
    """Stream a MANC subvolume and cache it as h5 (raw + labels)."""
    h5py = _h5py()

    os.makedirs(str(path), exist_ok=True)
    h5_path = os.path.join(str(path), f"{_bbox_to_str(bounding_box)}.h5")
    if os.path.exists(h5_path):
        return h5_path
    if not download:
        raise RuntimeError(f"No cached data at '{h5_path}'; set download=True to stream it.")
    try:
        import cloudvolume
    except ImportError:
        raise ImportError("The 'cloud-volume' package is required to stream MANC data.")

    x_min, x_max, y_min, y_max, z_min, z_max = bounding_box
    em_vol = cloudvolume.CloudVolume(EM_URL, use_https=True, mip=0, progress=True)
    seg_vol = cloudvolume.CloudVolume(SEG_URL, use_https=True, mip=0, progress=True)
    raw = np.array(em_vol[x_min:x_max, y_min:y_max, z_min:z_max])[..., 0].transpose(2, 1, 0)
    labels = np.array(seg_vol[x_min:x_max, y_min:y_max, z_min:z_max])[..., 0].transpose(2, 1, 0)
    with h5py.File(h5_path, "w") as f:
        f.attrs["bounding_box"] = bounding_box
        f.create_dataset("raw", data=raw.astype("uint8"), compression="gzip", chunks=True)
        f.create_dataset("labels", data=labels.astype("uint64"), compression="gzip", chunks=True)
    return h5_path


def get_manc_paths(path: Union[os.PathLike, str],
                   bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                   download: bool = False) -> List[str]:
    """Get paths to cached MANC subvolumes."""
    if bounding_boxes is None:
        bounding_boxes = [DEFAULT_BOUNDING_BOX]
    return [get_manc_data(path, bbox, download) for bbox in bounding_boxes]


def get_manc_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                     bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                     offsets=None, boundaries: bool = False,
                     download: bool = False, **kwargs):
    """Get the MANC dataset for neuron segmentation."""
    paths = get_manc_paths(path, bounding_boxes, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape, **kwargs)


def get_manc_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                    batch_size: int, bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                    offsets=None, boundaries: bool = False, download: bool = False,
                    **kwargs) -> DataLoader:
    """Get the MANC data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_manc_dataset(path, patch_shape, bounding_boxes=bounding_boxes, offsets=offsets,
                          boundaries=boundaries, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
