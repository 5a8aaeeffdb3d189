"""Hydra vulgaris dataset: whole-animal neuron segmentation in EM
(reference torch_em/data/datasets/electron_microscopy/hydra_vulgaris.py).

Publicly available at https://bossdb.org/project/zhang2025; streaming
requires the optional cloud-volume package. Subvolumes are cached as h5
(the reference uses sharded zarr-v3 stores; h5 is the cache format here).
"""

import hashlib
import os
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

HYDRA_EM_URL = "precomputed://https://bossdb-open-data.s3.amazonaws.com/zhang2025/image"
HYDRA_SEG_URL = "precomputed://https://bossdb-open-data.s3.amazonaws.com/zhang2025/neurons"

# Pre-defined bounding boxes in nm (x0, x1, y0, y1, z0, z1), each
# 32768 x 32768 x 18000 nm in densely annotated regions.
HYDRA_BOUNDING_BOXES = [
    (131072, 163840, 360448, 393216, 18000, 36000),
    (327680, 360448, 163840, 196608, 18000, 36000),
    (163840, 196608, 294912, 327680, 18000, 36000),
    (196608, 229376, 262144, 294912, 18000, 36000),
]


def _bbox_to_str(bbox):
    return hashlib.md5("_".join(str(v) for v in bbox).encode()).hexdigest()[:12]


def get_hydra_data(path: Union[os.PathLike, str],
                   bounding_box: Tuple[int, ...] = HYDRA_BOUNDING_BOXES[0],
                   image_mip: int = 3, seg_mip: int = 2,
                   download: bool = False) -> str:
    """Stream a Hydra subvolume (EM + neuron segmentation) and cache it as h5."""
    h5py = _h5py()

    os.makedirs(str(path), exist_ok=True)
    h5_path = os.path.join(str(path), f"hydra_{_bbox_to_str(bounding_box)}.h5")
    if os.path.exists(h5_path):
        return h5_path
    if not download:
        raise RuntimeError(f"No cached data at '{h5_path}'; set download=True to stream it.")
    try:
        from cloudvolume import CloudVolume
    except ImportError:
        raise ImportError("cloud-volume is required to stream the Hydra data.")

    em_cv = CloudVolume(HYDRA_EM_URL, use_https=True, mip=image_mip, progress=False,
                        fill_missing=True)
    seg_cv = CloudVolume(HYDRA_SEG_URL, use_https=True, mip=seg_mip, progress=False,
                         fill_missing=True)

    def to_voxels(cv, bbox):
        res = np.array(cv.resolution)
        x0, x1, y0, y1, z0, z1 = bbox
        return (int(np.floor(x0 / res[0])), int(np.ceil(x1 / res[0])),
                int(np.floor(y0 / res[1])), int(np.ceil(y1 / res[1])),
                int(np.floor(z0 / res[2])), int(np.ceil(z1 / res[2])))

    x0, x1, y0, y1, z0, z1 = to_voxels(em_cv, bounding_box)
    raw = np.array(em_cv[x0:x1, y0:y1, z0:z1])[..., 0].transpose(2, 1, 0)
    sx0, sx1, sy0, sy1, sz0, sz1 = to_voxels(seg_cv, bounding_box)
    seg = np.array(seg_cv[sx0:sx1, sy0:sy1, sz0:sz1])[..., 0].transpose(2, 1, 0)
    with h5py.File(h5_path, "w") as f:
        f.attrs["bounding_box_nm"] = bounding_box
        f.create_dataset("raw", data=raw.astype("uint8"), compression="gzip", chunks=True)
        f.create_dataset("labels", data=seg.astype("uint64"), compression="gzip", chunks=True)
    return h5_path


def get_hydra_paths(path: Union[os.PathLike, str],
                    bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                    download: bool = False) -> List[str]:
    """Get paths to cached Hydra subvolumes."""
    if bounding_boxes is None:
        bounding_boxes = [HYDRA_BOUNDING_BOXES[0]]
    return [get_hydra_data(path, bbox, download=download) for bbox in bounding_boxes]


def get_hydra_dataset(path: Union[os.PathLike, str], patch_shape,
                      bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                      offsets=None, boundaries: bool = False,
                      download: bool = False, **kwargs):
    """Get the Hydra vulgaris dataset for neuron segmentation."""
    paths = get_hydra_paths(path, bounding_boxes, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape, **kwargs)


def get_hydra_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                     bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                     offsets=None, boundaries: bool = False,
                     download: bool = False, **kwargs) -> DataLoader:
    """Get the Hydra vulgaris data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_hydra_dataset(path, patch_shape, bounding_boxes=bounding_boxes,
                           offsets=offsets, boundaries=boundaries, download=download,
                           **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
