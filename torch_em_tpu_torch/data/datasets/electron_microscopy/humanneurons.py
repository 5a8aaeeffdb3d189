"""Human Neurons (H01) dataset: neuron segmentation in the human cortex
petascale EM release (reference
torch_em/data/datasets/electron_microscopy/humanneurons.py).

Streams from the public H01 buckets (Shapson-Coe et al. 2021); requires the
optional cloud-volume package. EM is fetched at mip=1 (8 nm) to match the
C3 segmentation at mip=0. Subvolumes are cached as h5.
"""

import hashlib
import os
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

EM_URL = "gs://h01-release/data/20210601/4nm_raw"
SEG_URL = "gs://h01-release/data/20210601/c3"
# voxel coordinates (x0, x1, y0, y1, z0, z1): a 2048 x 2048 x 64 cortex region.
DEFAULT_BOUNDING_BOX = (271360, 273408, 201728, 203776, 2614, 2678)


def _bbox_to_str(bbox):
    return hashlib.md5("_".join(str(v) for v in bbox).encode()).hexdigest()[:12]


def get_humanneurons_data(path: Union[os.PathLike, str],
                          bounding_box: Tuple[int, ...] = DEFAULT_BOUNDING_BOX,
                          download: bool = False) -> str:
    """Stream an H01 subvolume (EM + segmentation) and cache it as h5."""
    h5py = _h5py()

    os.makedirs(str(path), exist_ok=True)
    h5_path = os.path.join(str(path), f"humanneurons_{_bbox_to_str(bounding_box)}.h5")
    if os.path.exists(h5_path):
        return h5_path
    if not download:
        raise RuntimeError(f"No cached data at '{h5_path}'; set download=True to stream it.")
    try:
        import cloudvolume
    except ImportError:
        raise ImportError("cloud-volume is required to stream the H01 data.")

    em_vol = cloudvolume.CloudVolume(EM_URL, use_https=True, mip=1, progress=False)
    seg_vol = cloudvolume.CloudVolume(SEG_URL, use_https=True, mip=0, progress=False,
                                      fill_missing=True)
    x0, x1, y0, y1, z0, z1 = bounding_box
    # mip=1 halves the in-plane voxel coordinates of the 4 nm reference frame.
    raw = np.array(em_vol[x0 // 2:x1 // 2, y0 // 2:y1 // 2, z0:z1])[..., 0].transpose(2, 1, 0)
    seg = np.array(seg_vol[x0 // 2:x1 // 2, y0 // 2:y1 // 2, z0:z1])[..., 0].transpose(2, 1, 0)
    with h5py.File(h5_path, "w") as f:
        f.attrs["bounding_box"] = bounding_box
        f.create_dataset("raw", data=raw.astype("uint8"), compression="gzip", chunks=True)
        f.create_dataset("labels", data=seg.astype("uint64"), compression="gzip", chunks=True)
    return h5_path


def get_humanneurons_paths(path: Union[os.PathLike, str],
                           bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                           download: bool = False) -> List[str]:
    """Get paths to cached H01 subvolumes."""
    if bounding_boxes is None:
        bounding_boxes = [DEFAULT_BOUNDING_BOX]
    return [get_humanneurons_data(path, bbox, download) for bbox in bounding_boxes]


def get_humanneurons_dataset(path: Union[os.PathLike, str], patch_shape,
                             bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                             offsets=None, boundaries: bool = False,
                             download: bool = False, **kwargs):
    """Get the Human Neurons dataset for neuron segmentation."""
    paths = get_humanneurons_paths(path, bounding_boxes, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape, **kwargs)


def get_humanneurons_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                            bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                            offsets=None, boundaries: bool = False,
                            download: bool = False, **kwargs) -> DataLoader:
    """Get the Human Neurons data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_humanneurons_dataset(path, patch_shape, bounding_boxes=bounding_boxes,
                                  offsets=offsets, boundaries=boundaries,
                                  download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
