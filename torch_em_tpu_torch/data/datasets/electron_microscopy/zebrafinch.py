"""Zebrafinch dataset: neuron segmentation in the songbird basal ganglia EM
volumes (j0126 / j0251) (reference
torch_em/data/datasets/electron_microscopy/zebrafinch.py).

Publicly available at https://syconn.esc.mpcdf.mpg.de; streaming requires
the optional cloud-volume package. Subvolumes are cached as h5 (the
reference uses sharded zarr-v3 stores; h5 is the cache format here).
"""

import hashlib
import os
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

J0251_BASE_URL = ("precomputed://https://syconn.esc.mpcdf.mpg.de"
                  "/j0251_72_seg_20210127_agglo2_syn_20220811_celltypes_20230822")
J0126_BASE_URL = "precomputed://https://syconn.esc.mpcdf.mpg.de"

DATASETS = {
    "j0251": {
        "em_url": f"{J0251_BASE_URL}/image",
        "seg_url": f"{J0251_BASE_URL}/segmentation",
        "bbox_nm": (0, 271190, 0, 273500, 0, 387350),
    },
    "j0126": {
        "em_url": f"{J0126_BASE_URL}/j0126/volume/image",
        "seg_url": f"{J0126_BASE_URL}/volume/segmentation",
        "bbox_nm": (0, 106640, 0, 109130, 0, 114000),
    },
}
# a small central training region in nm (x0, x1, y0, y1, z0, z1)
DEFAULT_BOUNDING_BOX = (40000, 60000, 40000, 60000, 40000, 48000)


def _bbox_to_str(bbox):
    return hashlib.md5("_".join(str(v) for v in bbox).encode()).hexdigest()[:12]


def get_zebrafinch_data(path: Union[os.PathLike, str], dataset: str = "j0126",
                        bounding_box: Tuple[int, ...] = DEFAULT_BOUNDING_BOX,
                        download: bool = False) -> str:
    """Stream a zebrafinch subvolume (EM + neuron segmentation) and cache it
    as h5."""
    h5py = _h5py()

    assert dataset in DATASETS, f"Invalid dataset: {dataset}"
    os.makedirs(str(path), exist_ok=True)
    h5_path = os.path.join(str(path), f"{dataset}_{_bbox_to_str(bounding_box)}.h5")
    if os.path.exists(h5_path):
        return h5_path
    if not download:
        raise RuntimeError(f"No cached data at '{h5_path}'; set download=True to stream it.")
    try:
        from cloudvolume import CloudVolume
    except ImportError:
        raise ImportError("cloud-volume is required to stream the zebrafinch data.")

    cfg = DATASETS[dataset]
    em_cv = CloudVolume(cfg["em_url"], use_https=True, mip=0, progress=False,
                        fill_missing=True)
    seg_cv = CloudVolume(cfg["seg_url"], use_https=True, mip=0, progress=False,
                         fill_missing=True)

    def to_voxels(cv, bbox):
        res = np.array(cv.resolution)
        x0, x1, y0, y1, z0, z1 = bbox
        return (int(x0 // res[0]), int(x1 // res[0]), int(y0 // res[1]),
                int(y1 // res[1]), int(z0 // res[2]), int(z1 // res[2]))

    x0, x1, y0, y1, z0, z1 = to_voxels(em_cv, bounding_box)
    raw = np.array(em_cv[x0:x1, y0:y1, z0:z1])[..., 0].transpose(2, 1, 0)
    sx0, sx1, sy0, sy1, sz0, sz1 = to_voxels(seg_cv, bounding_box)
    seg = np.array(seg_cv[sx0:sx1, sy0:sy1, sz0:sz1])[..., 0].transpose(2, 1, 0)
    with h5py.File(h5_path, "w") as f:
        f.attrs["bounding_box_nm"] = bounding_box
        f.create_dataset("raw", data=raw.astype("uint8"), compression="gzip", chunks=True)
        f.create_dataset("labels", data=seg.astype("uint64"), compression="gzip", chunks=True)
    return h5_path


def get_zebrafinch_paths(path: Union[os.PathLike, str], dataset: str = "j0126",
                         bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                         download: bool = False) -> List[str]:
    """Get paths to cached zebrafinch subvolumes."""
    if bounding_boxes is None:
        bounding_boxes = [DEFAULT_BOUNDING_BOX]
    return [get_zebrafinch_data(path, dataset, bbox, download) for bbox in bounding_boxes]


def get_zebrafinch_dataset(path: Union[os.PathLike, str], patch_shape,
                           dataset: str = "j0126",
                           bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                           offsets=None, boundaries: bool = False,
                           download: bool = False, **kwargs):
    """Get the zebrafinch dataset for neuron segmentation."""
    paths = get_zebrafinch_paths(path, dataset, bounding_boxes, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape, **kwargs)


def get_zebrafinch_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                          dataset: str = "j0126",
                          bounding_boxes: Optional[List[Tuple[int, ...]]] = None,
                          offsets=None, boundaries: bool = False,
                          download: bool = False, **kwargs) -> DataLoader:
    """Get the zebrafinch data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_zebrafinch_dataset(path, patch_shape, dataset=dataset,
                                bounding_boxes=bounding_boxes, offsets=offsets,
                                boundaries=boundaries, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
