"""Wildenberg dataset: synapse (PSD / vesicle cloud) and neuron
segmentation in mouse V1 EM (reference
torch_em/data/datasets/electron_microscopy/wildenberg.py).

Publicly available at https://bossdb.org/project/wildenberg2023; streaming
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

WILDENBERG_S3_BASE = "precomputed://https://bossdb-open-data.s3.amazonaws.com/wildenberg2023"
EXPERIMENTS = {
    "p105": {"exp_name": "mouse_v1_l4_p105", "em_channel": "em", "em_axes_swapped": True,
             "bbox_nm": (576, 120576, 576, 136512, 160, 36320)},
    "p14": {"exp_name": "mouse_v1_l4_p14", "em_channel": "em_aligned",
            "em_axes_swapped": False, "bbox_nm": (0, 80256, 0, 115200, 0, 52320)},
}
LABEL_CHANNELS = {
    "psd": "psd_autoseg",
    "vesicle_cloud": "vesicle_autoseg",
    "saturated": "saturated_autoseg",
}
# a small default training region in nm (x0, x1, y0, y1, z0, z1)
DEFAULT_BOUNDING_BOX = (20000, 40000, 20000, 40000, 4000, 12000)


def _bbox_to_str(bbox):
    return hashlib.md5("_".join(str(v) for v in bbox).encode()).hexdigest()[:12]


def get_wildenberg_data(path: Union[os.PathLike, str], experiment: str = "p14",
                        labels: str = "psd",
                        bounding_box: Tuple[int, ...] = DEFAULT_BOUNDING_BOX,
                        download: bool = False) -> str:
    """Stream a Wildenberg subvolume (EM + one label channel) and cache it
    as h5."""
    h5py = _h5py()

    assert experiment in EXPERIMENTS, f"Invalid experiment: {experiment}"
    assert labels in LABEL_CHANNELS, f"Invalid labels: {labels}"
    os.makedirs(str(path), exist_ok=True)
    h5_path = os.path.join(str(path), f"{experiment}_{labels}_{_bbox_to_str(bounding_box)}.h5")
    if os.path.exists(h5_path):
        return h5_path
    if not download:
        raise RuntimeError(f"No cached data at '{h5_path}'; set download=True to stream it.")
    try:
        from cloudvolume import CloudVolume
    except ImportError:
        raise ImportError("cloud-volume is required to stream the Wildenberg data.")

    exp = EXPERIMENTS[experiment]
    em_url = f"{WILDENBERG_S3_BASE}/{exp['exp_name']}/{exp['em_channel']}"
    seg_url = f"{WILDENBERG_S3_BASE}/{exp['exp_name']}/{LABEL_CHANNELS[labels]}"
    em_cv = CloudVolume(em_url, use_https=True, mip=0, progress=False, fill_missing=True)
    seg_cv = CloudVolume(seg_url, use_https=True, mip=0, progress=False, fill_missing=True)

    def to_voxels(cv, bbox):
        res = np.array(cv.resolution)
        x0, x1, y0, y1, z0, z1 = bbox
        return (int(x0 // res[0]), int(x1 // res[0]), int(y0 // res[1]),
                int(y1 // res[1]), int(z0 // res[2]), int(z1 // res[2]))

    x0, x1, y0, y1, z0, z1 = to_voxels(em_cv, bounding_box)
    raw = np.array(em_cv[x0:x1, y0:y1, z0:z1])[..., 0].transpose(2, 1, 0)
    if exp["em_axes_swapped"]:
        raw = raw.transpose(0, 2, 1)
    sx0, sx1, sy0, sy1, sz0, sz1 = to_voxels(seg_cv, bounding_box)
    seg = np.array(seg_cv[sx0:sx1, sy0:sy1, sz0:sz1])[..., 0].transpose(2, 1, 0)
    with h5py.File(h5_path, "w") as f:
        f.attrs["bounding_box_nm"] = bounding_box
        f.create_dataset("raw", data=raw.astype("uint8"), compression="gzip", chunks=True)
        f.create_dataset("labels", data=seg.astype("uint64"), compression="gzip", chunks=True)
    return h5_path


def get_wildenberg_paths(path: Union[os.PathLike, str], experiment: str = "p14",
                         labels: str = "psd",
                         bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                         download: bool = False) -> List[str]:
    """Get paths to cached Wildenberg subvolumes."""
    if bounding_boxes is None:
        bounding_boxes = [DEFAULT_BOUNDING_BOX]
    return [get_wildenberg_data(path, experiment, labels, bbox, download)
            for bbox in bounding_boxes]


def get_wildenberg_dataset(path: Union[os.PathLike, str], patch_shape,
                           experiment: str = "p14", labels: str = "psd",
                           bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                           download: bool = False, **kwargs):
    """Get the Wildenberg dataset."""
    paths = get_wildenberg_paths(path, experiment, labels, bounding_boxes, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape, **kwargs)


def get_wildenberg_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                          experiment: str = "p14", labels: str = "psd",
                          bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                          download: bool = False, **kwargs) -> DataLoader:
    """Get the Wildenberg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_wildenberg_dataset(path, patch_shape, experiment=experiment, labels=labels,
                                bounding_boxes=bounding_boxes, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
