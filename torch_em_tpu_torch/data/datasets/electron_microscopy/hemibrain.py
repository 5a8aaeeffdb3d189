"""Hemibrain dataset: neuron / mito / tissue segmentation in the Janelia
FlyEM hemibrain EM volume (reference
torch_em/data/datasets/electron_microscopy/hemibrain.py).

Streams subvolumes from the public GCS buckets (requires the optional
cloud-volume package); publication: https://doi.org/10.7554/eLife.57443
"""

import hashlib
import os
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

EM_URL = "gs://neuroglancer-janelia-flyem-hemibrain/emdata/clahe_yz/jpeg"
LABEL_URLS = {
    "neurons": "gs://neuroglancer-janelia-flyem-hemibrain/v1.2/segmentation",
    "mito": "gs://neuroglancer-janelia-flyem-hemibrain/mito_20190717.27250582",
    "tissue": "gs://neuroglancer-janelia-flyem-hemibrain/mask_normalized_round6",
}
# mito and tissue are published at 16 nm (2x coarser than the 8 nm EM)
LABEL_RESOLUTION_FACTOR = {"neurons": 1, "mito": 2, "tissue": 2}

# a representative 1024^3 subvolume near the center (8 nm voxels, xyz order)
DEFAULT_BOUNDING_BOX = (15000, 16024, 18000, 19024, 18000, 19024)


def _bbox_to_str(bbox):
    return hashlib.md5("_".join(str(v) for v in bbox).encode()).hexdigest()[:12]


def get_hemibrain_data(path: Union[os.PathLike, str],
                       bounding_box: Tuple[int, ...] = DEFAULT_BOUNDING_BOX,
                       labels: str = "neurons", download: bool = False) -> str:
    """Stream a hemibrain subvolume and cache it as h5 (raw + labels)."""
    h5py = _h5py()

    assert labels in LABEL_URLS, f"Invalid labels: {labels}"
    os.makedirs(str(path), exist_ok=True)
    h5_path = os.path.join(str(path), f"{labels}_{_bbox_to_str(bounding_box)}.h5")
    if os.path.exists(h5_path):
        return h5_path
    if not download:
        raise RuntimeError(f"No cached data at '{h5_path}'; set download=True to stream it.")
    try:
        import cloudvolume
    except ImportError:
        raise ImportError("The 'cloud-volume' package is required to stream hemibrain data.")

    x_min, x_max, y_min, y_max, z_min, z_max = bounding_box
    em_vol = cloudvolume.CloudVolume(EM_URL, use_https=True, mip=0, progress=True)
    raw = np.array(em_vol[x_min:x_max, y_min:y_max, z_min:z_max])[..., 0].transpose(2, 1, 0)

    factor = LABEL_RESOLUTION_FACTOR[labels]
    seg_vol = cloudvolume.CloudVolume(LABEL_URLS[labels], use_https=True, mip=0, progress=True)
    seg = np.array(seg_vol[
        x_min // factor:x_max // factor,
        y_min // factor:y_max // factor,
        z_min // factor:z_max // factor,
    ])[..., 0].transpose(2, 1, 0)
    if factor > 1:  # upsample coarse labels to the EM resolution
        seg = np.repeat(np.repeat(np.repeat(seg, factor, 0), factor, 1), factor, 2)
        seg = seg[: raw.shape[0], : raw.shape[1], : raw.shape[2]]

    with h5py.File(h5_path, "w") as f:
        f.attrs["bounding_box"] = bounding_box
        f.create_dataset("raw", data=raw.astype("uint8"), compression="gzip", chunks=True)
        f.create_dataset("labels", data=seg.astype("uint64"), compression="gzip", chunks=True)
    return h5_path


def get_hemibrain_paths(path: Union[os.PathLike, str],
                        bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                        labels: str = "neurons", download: bool = False) -> List[str]:
    """Get paths to cached hemibrain subvolumes."""
    if bounding_boxes is None:
        bounding_boxes = [DEFAULT_BOUNDING_BOX]
    return [get_hemibrain_data(path, bbox, labels, download) for bbox in bounding_boxes]


def get_hemibrain_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                          bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                          labels: str = "neurons", offsets=None, boundaries: bool = False,
                          download: bool = False, **kwargs):
    """Get the hemibrain dataset."""
    paths = get_hemibrain_paths(path, bounding_boxes, labels, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape, **kwargs)


def get_hemibrain_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                         batch_size: int,
                         bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                         labels: str = "neurons", offsets=None, boundaries: bool = False,
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the hemibrain data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_hemibrain_dataset(path, patch_shape, bounding_boxes=bounding_boxes, labels=labels,
                               offsets=offsets, boundaries=boundaries, download=download,
                               **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
