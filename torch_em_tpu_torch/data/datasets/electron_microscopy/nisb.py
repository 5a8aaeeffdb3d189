"""NISB: large-scale synthetic benchmark for neuron instance segmentation in
connectomics (reference torch_em/data/datasets/electron_microscopy/nisb.py).

9 settings of varying difficulty, each with 5 training cubes (train_100: 100),
1 validation cube and 1 test cube; cubes are 27µm side length at 9x9x20 nm
(liconn: 9x9x12 nm). The multichannel setting stores 8-channel embeddings.
Data is streamed from S3 (via the optional ``s3fs`` package) and cached as
local zarr stores with (z, y, x) axis order under keys ``img``/``seg``.

Described in https://doi.org/10.17617/1.r2mm-1h33; please cite it.
"""

import os
import shutil
import warnings
from glob import glob
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils import zarr_n5
from .. import util

NISB_S3_ENDPOINT = "https://s3.nexus.mpcdf.mpg.de:443"
NISB_S3_BUCKET = "nisb"

NISB_SETTINGS = [
    "base", "train_100", "slice_perturbed", "pos_guidance", "neg_guidance",
    "no_touch_thick", "touching_thin", "liconn", "multichannel",
]

NISB_CHUNK_SHAPE = (64, 64, 64)


def _nisb_n_seeds(setting: str, split: str) -> int:
    if split in ("val", "test"):
        return 1
    return 100 if setting == "train_100" else 5


def _nisb_open_remote(setting: str, split: str, seed_idx: int):
    """Open a NISB seed cube from S3 as a zarr v2 group via s3fs."""
    try:
        import s3fs
    except ImportError:
        raise ImportError("The 's3fs' package is required to download NISB data: pip install s3fs")
    import zarr

    fs = s3fs.S3FileSystem(anon=True, endpoint_url=NISB_S3_ENDPOINT)
    s3_path = f"{NISB_S3_BUCKET}/{setting}/{split}/seed{seed_idx}/data.zarr"
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*asynchronous.*")
        store = zarr.storage.FsspecStore(fs=fs, path=s3_path)
        return zarr.open_group(store, mode="r", zarr_format=2)


def _nisb_write_cube(src, zarr_path: str) -> None:
    """Stream a NISB cube from the zarr v2 source to a local zarr store,
    transposing (x, y, z) -> (z, y, x) and squeezing the trailing singleton
    channel dim on the image. The local store is written by the port's own
    zarr writer (``utils/zarr_n5.py``), so zarr-python is only needed for the
    remote side."""
    img_v2, seg_v2 = src["img"], src["seg"]
    squeeze_img = img_v2.ndim == 4 and img_v2.shape[-1] == 1
    if squeeze_img:
        img_shape = (img_v2.shape[2], img_v2.shape[1], img_v2.shape[0])
    else:
        img_shape = (img_v2.shape[2], img_v2.shape[1], img_v2.shape[0], img_v2.shape[3])
    seg_shape = (seg_v2.shape[2], seg_v2.shape[1], seg_v2.shape[0])

    tmp_path = zarr_path + ".tmp"
    if os.path.exists(tmp_path):
        shutil.rmtree(tmp_path)

    def _create(key, shape, dtype, chunks):
        return zarr_n5.create_array(tmp_path, key, shape, dtype, chunks, "zarr")

    img_out = _create("img", img_shape, "uint8", NISB_CHUNK_SHAPE + tuple(img_shape[3:]))
    seg_out = _create("seg", seg_shape, "uint16", NISB_CHUNK_SHAPE)

    Z, Y, X = seg_shape
    step = 512
    for z0 in range(0, Z, step):
        for y0 in range(0, Y, step):
            for x0 in range(0, X, step):
                z1, y1, x1 = min(z0 + step, Z), min(y0 + step, Y), min(x0 + step, X)
                block_img = np.asarray(img_v2[x0:x1, y0:y1, z0:z1])
                if squeeze_img:
                    block_img = block_img[..., 0]
                img_out[z0:z1, y0:y1, x0:x1] = np.moveaxis(block_img, [0, 2], [2, 0])
                seg_out[z0:z1, y0:y1, x0:x1] = np.asarray(seg_v2[x0:x1, y0:y1, z0:z1]).transpose(2, 1, 0)
    shutil.move(tmp_path, zarr_path)


def get_nisb_data(path: Union[os.PathLike, str], setting: str, split: str,
                  download: bool) -> str:
    """Stream and cache NISB data for a setting/split; returns the split dir."""
    assert setting in NISB_SETTINGS, f"Invalid setting '{setting}'. Choose from {NISB_SETTINGS}."
    assert split in ("train", "val", "test")
    split_dir = os.path.join(str(path), setting, split)

    for i in range(_nisb_n_seeds(setting, split)):
        seed_dir = os.path.join(split_dir, f"seed{i}")
        zarr_path = os.path.join(seed_dir, "data.zarr")
        if os.path.isdir(zarr_path):
            continue
        if not download:
            raise RuntimeError(f"No cached data at '{zarr_path}'; set download=True to stream it.")
        os.makedirs(seed_dir, exist_ok=True)
        src = _nisb_open_remote(setting, split, i)
        _nisb_write_cube(src, zarr_path)
    return split_dir


def get_nisb_paths(path: Union[os.PathLike, str], setting: str = "base",
                   split: str = "train", download: bool = False) -> List[str]:
    """Paths to the cached NISB zarr stores, one per cube/seed."""
    split_dir = get_nisb_data(path, setting, split, download)
    paths = sorted(glob(os.path.join(split_dir, "seed*", "data.zarr")))
    if not paths:
        raise RuntimeError(f"No zarr files found in '{split_dir}'.")
    return paths


def get_nisb_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                     setting: str = "base", split: str = "train", download: bool = False,
                     offsets: Optional[List[List[int]]] = None, boundaries: bool = False,
                     **kwargs):
    """Dataset for neuron instance segmentation over NISB cubes (keys img/seg)."""
    assert len(patch_shape) == 3
    paths = get_nisb_paths(path, setting, split, download)
    kwargs = util.update_kwargs(kwargs, "is_seg_dataset", True)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets)
    return default_segmentation_dataset(
        raw_paths=paths, raw_key="img",
        label_paths=paths, label_key="seg",
        patch_shape=patch_shape, **kwargs,
    )


def get_nisb_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                    batch_size: int, setting: str = "base", split: str = "train",
                    download: bool = False, offsets: Optional[List[List[int]]] = None,
                    boundaries: bool = False, **kwargs) -> DataLoader:
    """DataLoader for neuron instance segmentation in the NISB dataset."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_nisb_dataset(path, patch_shape, setting, split, download,
                          offsets, boundaries, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
