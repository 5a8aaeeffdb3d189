"""MICrONS datasets (reference torch_em/data/datasets/electron_microscopy/microns.py).

Two sources:

- **Zenodo training volumes** (basil, minnie, pinky) —
  https://doi.org/10.5281/zenodo.5760218: EM with sparse neuron instance
  segmentation and (pinky only) sparse mitochondria labels, as tar.gz of h5.
- **minnie65 cubic millimeter** — https://doi.org/10.1038/s41586-025-08790-w:
  the full mouse V1 volume, streamed by bounding box from public cloud
  storage with the optional ``cloud-volume`` package and cached locally.

Please cite the relevant publication if you use either dataset.
"""

import glob
import hashlib
import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

ZENODO_URLS = {
    "basil": "https://zenodo.org/records/5760218/files/basil.tar.gz?download=1",
    "minnie": "https://zenodo.org/records/5760218/files/minnie.tar.gz?download=1",
    "pinky": "https://zenodo.org/records/5760218/files/pinky.tar.gz?download=1",
}
# SHA256 checksums are not published; download warns but does not fail.
ZENODO_CHECKSUMS = {"basil": None, "minnie": None, "pinky": None}

ZENODO_LABEL_KEYS = {
    "neuron": "volumes/segmentation",
    "mitochondria": "volumes/mitochondria",
}
# Mitochondria labels are only present in the pinky volume.
ZENODO_MITO_VOLUMES = ["pinky"]

MINNIE65_EM_URL = "precomputed://https://bossdb-open-data.s3.amazonaws.com/iarpa_microns/minnie/minnie65/em"
MINNIE65_SEG_URL = "precomputed://https://storage.googleapis.com/iarpa_microns/minnie/minnie65/seg_m1300/"

# Pre-defined bounding boxes in nm (x_min, x_max, y_min, y_max, z_min, z_max);
# blocks of 4096x4096x512 vox at 8x8x40 nm (mip=0).
MINNIE65_BOUNDING_BOXES = {
    "train": [
        (384792, 417560, 549540, 582308, 833880, 854360),
        (263368, 296136, 489060, 521828, 836200, 856680),
        (268376, 301144, 562448, 595216, 829560, 850040),
        (279428, 312196, 802124, 834892, 796920, 817400),
        (365248, 398016, 1005708, 1038476, 796920, 817400),
        (462808, 495576, 1054232, 1087000, 796920, 817400),
        (506668, 539436, 1006572, 1039340, 781720, 802200),
        (588344, 621112, 973072, 1005840, 781720, 802200),
    ],
    "val": [
        (733048, 765816, 525324, 558092, 787320, 807800),
        (1131936, 1164704, 618204, 650972, 723880, 744360),
    ],
    "test": [
        (822668, 855436, 414812, 447580, 787320, 807800),
        (986364, 1019132, 398236, 431004, 789320, 809800),
        (1101648, 1134416, 563036, 595804, 789320, 809800),
        (1152312, 1185080, 453124, 485892, 784280, 804760),
    ],
}


def get_microns_data(path: Union[os.PathLike, str], volume: str, download: bool) -> str:
    """Download and extract one MICrONS Zenodo volume ('basil'/'minnie'/'pinky')."""
    assert volume in ZENODO_URLS, f"Invalid volume '{volume}'. Choose from {list(ZENODO_URLS.keys())}."
    os.makedirs(str(path), exist_ok=True)
    volume_dir = os.path.join(str(path), volume)
    if not os.path.exists(volume_dir):
        tar_path = os.path.join(str(path), f"{volume}.tar.gz")
        util.download_source(tar_path, ZENODO_URLS[volume], download, ZENODO_CHECKSUMS[volume])
        util.unzip_tarfile(tar_path, str(path), remove=True)
    return volume_dir


def get_microns_paths(path: Union[os.PathLike, str], volumes: Optional[Sequence[str]],
                      download: bool, label_key: str = "volumes/segmentation") -> List[str]:
    """Paths to Zenodo volume h5 files; files whose image and label shapes
    mismatch are skipped with a message."""
    h5py = _h5py()

    if volumes is None:
        volumes = list(ZENODO_URLS.keys())
    paths = []
    for vol in volumes:
        vol_dir = get_microns_data(path, vol, download)
        for fpath in sorted(glob.glob(os.path.join(vol_dir, "*.h5"))):
            with h5py.File(fpath, "r") as f:
                if label_key not in f:
                    continue
                img_shape = f["volumes/image"].shape
                lbl_shape = f[label_key].shape
            if img_shape == lbl_shape:
                paths.append(fpath)
            else:
                print(f"Skipping {os.path.basename(fpath)}: image {img_shape} != {label_key} {lbl_shape}")
    return paths


def get_microns_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                        volumes: Optional[Sequence[str]] = None, label_choice: str = "neuron",
                        download: bool = False, offsets: Optional[List[List[int]]] = None,
                        boundaries: bool = False, **kwargs):
    """Dataset over the MICrONS Zenodo volumes (sparse neuron or mitochondria labels)."""
    assert len(patch_shape) == 3
    assert label_choice in ZENODO_LABEL_KEYS, \
        f"Invalid label_choice '{label_choice}'. Choose from {list(ZENODO_LABEL_KEYS.keys())}."
    if label_choice == "mitochondria":
        volumes = [v for v in (volumes or list(ZENODO_URLS.keys())) if v in ZENODO_MITO_VOLUMES]
        if not volumes:
            raise ValueError(f"Mitochondria labels are only available in: {ZENODO_MITO_VOLUMES}.")
    label_key = ZENODO_LABEL_KEYS[label_choice]
    h5_paths = get_microns_paths(path, volumes, download, label_key=label_key)

    kwargs = util.update_kwargs(kwargs, "is_seg_dataset", True)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets)

    return default_segmentation_dataset(
        raw_paths=h5_paths, raw_key="volumes/image",
        label_paths=h5_paths, label_key=label_key,
        patch_shape=patch_shape, **kwargs,
    )


def get_microns_loader(path: Union[os.PathLike, str], batch_size: int,
                       patch_shape: Tuple[int, int, int],
                       volumes: Optional[Sequence[str]] = None, label_choice: str = "neuron",
                       download: bool = False, offsets: Optional[List[List[int]]] = None,
                       boundaries: bool = False, **kwargs) -> DataLoader:
    """DataLoader over the MICrONS Zenodo volumes."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_microns_dataset(path, patch_shape, volumes, label_choice, download,
                             offsets, boundaries, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)


def _minnie65_bbox_to_str(bbox):
    return hashlib.md5("_".join(str(v) for v in bbox).encode()).hexdigest()[:12]


def get_microns_minnie65_data(path: Union[os.PathLike, str], bounding_box: Tuple[float, ...],
                              em_mip: int = 0, seg_mip: int = 0, download: bool = False) -> str:
    """Stream and cache one minnie65 bounding box (EM uint8 + neuron labels
    uint32, both (z, y, x)) as an h5 file.

    The reference caches sharded zarr-v3 stores; h5 is the cache format here
    (same keys 'raw'/'labels', same axis order).
    """
    h5py = _h5py()

    os.makedirs(str(path), exist_ok=True)
    h5_path = os.path.join(str(path), f"minnie65_{_minnie65_bbox_to_str(bounding_box)}.h5")
    if os.path.exists(h5_path):
        return h5_path
    if not download:
        raise RuntimeError(f"No cached data at '{h5_path}'; set download=True to stream it.")
    try:
        from cloudvolume import CloudVolume
    except ImportError:
        raise ImportError("The 'cloud-volume' package is required to stream minnie65 data.")

    em_cv = CloudVolume(MINNIE65_EM_URL, use_https=True, mip=em_mip, progress=True, fill_missing=True)
    seg_cv = CloudVolume(MINNIE65_SEG_URL, use_https=True, mip=seg_mip, progress=True, fill_missing=True)

    def fetch(cv, dtype):
        scale = np.array(cv.resolution)
        x0, x1, y0, y1, z0, z1 = (
            int(np.floor(bounding_box[0] / scale[0])), int(np.ceil(bounding_box[1] / scale[0])),
            int(np.floor(bounding_box[2] / scale[1])), int(np.ceil(bounding_box[3] / scale[1])),
            int(np.floor(bounding_box[4] / scale[2])), int(np.ceil(bounding_box[5] / scale[2])),
        )
        block = np.asarray(cv[x0:x1, y0:y1, z0:z1])
        if block.ndim == 4:
            block = block[..., 0]
        return block.transpose(2, 1, 0).astype(dtype)

    raw = fetch(em_cv, "uint8")
    labels = fetch(seg_cv, "uint32")
    with h5py.File(h5_path, "w") as f:
        f.attrs["bounding_box_nm"] = list(bounding_box)
        f.attrs["em_mip"] = em_mip
        f.attrs["seg_mip"] = seg_mip
        f.create_dataset("raw", data=raw, compression="gzip", chunks=True)
        f.create_dataset("labels", data=labels, compression="gzip", chunks=True)
    return h5_path


def get_microns_minnie65_paths(path: Union[os.PathLike, str], split: Optional[str] = None,
                               bounding_boxes: Optional[Sequence[Tuple[float, ...]]] = None,
                               em_mip: int = 0, seg_mip: int = 0,
                               download: bool = False) -> List[str]:
    """Paths to cached minnie65 stores; ``bounding_boxes`` overrides
    split-based selection, no split selects all pre-defined boxes."""
    if bounding_boxes is not None:
        boxes = list(bounding_boxes)
    elif split is not None:
        assert split in MINNIE65_BOUNDING_BOXES, \
            f"Invalid split '{split}'. Choose from {list(MINNIE65_BOUNDING_BOXES.keys())}."
        boxes = MINNIE65_BOUNDING_BOXES[split]
    else:
        boxes = [bb for split_boxes in MINNIE65_BOUNDING_BOXES.values() for bb in split_boxes]
    return [get_microns_minnie65_data(path, bb, em_mip, seg_mip, download) for bb in boxes]


def get_microns_minnie65_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                                 split: Optional[str] = None,
                                 bounding_boxes: Optional[Sequence[Tuple[float, ...]]] = None,
                                 em_mip: int = 0, seg_mip: int = 0, download: bool = False,
                                 offsets: Optional[List[List[int]]] = None,
                                 boundaries: bool = False, **kwargs):
    """Dataset for neuron instance segmentation over cached minnie65 boxes."""
    paths = get_microns_minnie65_paths(path, split, bounding_boxes, em_mip, seg_mip, download)
    kwargs = util.update_kwargs(kwargs, "is_seg_dataset", True)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets)
    return default_segmentation_dataset(
        raw_paths=paths, raw_key="raw",
        label_paths=paths, label_key="labels",
        patch_shape=patch_shape, **kwargs,
    )


def get_microns_minnie65_loader(path: Union[os.PathLike, str], batch_size: int,
                                patch_shape: Tuple[int, int, int], split: Optional[str] = None,
                                bounding_boxes: Optional[Sequence[Tuple[float, ...]]] = None,
                                em_mip: int = 0, seg_mip: int = 0, download: bool = False,
                                offsets: Optional[List[List[int]]] = None,
                                boundaries: bool = False, **kwargs) -> DataLoader:
    """DataLoader for neuron instance segmentation over cached minnie65 boxes."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_microns_minnie65_dataset(path, patch_shape, split, bounding_boxes,
                                      em_mip, seg_mip, download, offsets, boundaries, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
