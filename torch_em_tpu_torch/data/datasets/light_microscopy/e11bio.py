"""E11bio PRISM dataset: multi-channel expansion microscopy of mouse
hippocampal CA3 with dense neuron instance segmentation (reference
torch_em/data/datasets/light_microscopy/e11bio.py).

Pre-packaged training crops on S3 (s3://e11bio-prism, anonymous) in two
flavours: 'instance' (14 crops) and 'semantic' (17 crops). Channels are
stored as separate (Z, Y, X) datasets 'raw/ch_00', 'raw/ch_01', ...; channel
counts vary per crop (10-18, indices 0-9 safe everywhere). Streaming requires
the optional ``s3fs`` package. Publication:
https://www.biorxiv.org/content/10.1101/2025.09.26.678648v1.
"""

import os
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

S3_BASE = "e11bio-prism/ls/models/training_data"

SPLIT_NUM_CROPS = {"instance": 14, "semantic": 17}


def _get_store(split, crop_id):
    import s3fs

    fs = s3fs.S3FileSystem(anon=True)
    return s3fs.S3Map(f"{S3_BASE}/{split}/crop_{crop_id}.zarr", s3=fs)


def get_e11bio_data(path: Union[os.PathLike, str], split: str = "instance",
                    crop_ids: Optional[List[int]] = None,
                    download: bool = False) -> List[str]:
    """Stream E11bio PRISM crops from S3 and cache them as h5 files with
    per-channel raw datasets and center-aligned uint32 labels."""
    h5py = _h5py()

    from ....ops.host import relabel_consecutive

    if split not in SPLIT_NUM_CROPS:
        raise ValueError(f"split must be one of {list(SPLIT_NUM_CROPS)}, got {split!r}")
    if crop_ids is None:
        crop_ids = list(range(SPLIT_NUM_CROPS[split]))

    split_dir = os.path.join(str(path), split)
    os.makedirs(split_dir, exist_ok=True)

    h5_paths = []
    for crop_id in crop_ids:
        h5_path = os.path.join(split_dir, f"crop_{crop_id}.h5")
        h5_paths.append(h5_path)
        if os.path.exists(h5_path):
            continue
        if not download:
            raise RuntimeError(f"No cached data found at '{h5_path}'. Set download=True to stream it from S3.")
        try:
            import s3fs  # noqa: F401
        except ImportError:
            raise ImportError("The 's3fs' package is required to access the E11bio dataset.")
        import zarr

        f = zarr.open(_get_store(split, crop_id), mode="r")
        raw_arr = f["raw"][:]        # (C, Z, Y, X)
        labels_arr = f["labels"][:]  # (Z, Y, X)

        # align raw spatially to labels using the stored offsets
        raw_offset = f["raw"].attrs.get("offset", [0, 0, 0])
        lbl_offset = f["labels"].attrs.get("offset", [0, 0, 0])
        resolution = f["raw"].attrs.get("resolution", [1, 1, 1])
        z0, y0, x0 = (round((lo - ro) / res) for lo, ro, res
                      in zip(lbl_offset, raw_offset, resolution))
        lz, ly, lx = labels_arr.shape
        raw_arr = raw_arr[:, z0:z0 + lz, y0:y0 + ly, x0:x0 + lx]

        labels_arr = relabel_consecutive(labels_arr)[0]

        with h5py.File(h5_path, "w") as out:
            out.attrs["crop_id"] = crop_id
            out.attrs["split"] = split
            out.attrs["num_channels"] = raw_arr.shape[0]
            raw_grp = out.create_group("raw")
            for ch_idx, ch_data in enumerate(raw_arr):
                raw_grp.create_dataset(f"ch_{ch_idx:02d}", data=ch_data.astype("uint8"),
                                       compression="gzip", chunks=True)
            out.create_dataset("labels", data=labels_arr.astype("uint32"),
                               compression="gzip", chunks=True)
    return h5_paths


def get_e11bio_paths(path: Union[os.PathLike, str], split: str = "instance",
                     crop_ids: Optional[List[int]] = None,
                     download: bool = False) -> List[str]:
    """Paths to the cached E11bio PRISM h5 files."""
    return get_e11bio_data(path, split, crop_ids, download)


def get_e11bio_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                       split: str = "instance", crop_ids: Optional[List[int]] = None,
                       channel: int = 0, download: bool = False,
                       offsets: Optional[List[List[int]]] = None,
                       boundaries: bool = False, **kwargs):
    """Dataset for neuron instance/semantic segmentation in E11bio PRISM crops."""
    assert len(patch_shape) == 3
    paths = get_e11bio_paths(path, split, crop_ids, download)
    kwargs = util.update_kwargs(kwargs, "is_seg_dataset", True)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets)
    return default_segmentation_dataset(
        raw_paths=paths, raw_key=f"raw/ch_{channel:02d}",
        label_paths=paths, label_key="labels",
        patch_shape=patch_shape, ndim=3, **kwargs,
    )


def get_e11bio_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int, int],
                      batch_size: int, split: str = "instance",
                      crop_ids: Optional[List[int]] = None, channel: int = 0,
                      download: bool = False, offsets: Optional[List[List[int]]] = None,
                      boundaries: bool = False, **kwargs) -> DataLoader:
    """DataLoader for neuron instance/semantic segmentation in E11bio PRISM."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_e11bio_dataset(path, patch_shape, split, crop_ids, channel, download,
                            offsets, boundaries, **ds_kwargs)
    return get_data_loader(ds, batch_size, **loader_kwargs)
