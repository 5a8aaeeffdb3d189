"""ASEM dataset: segmentation of cellular structures (mito/golgi/er/ccp/np)
in FIB-SEM (reference torch_em/data/datasets/electron_microscopy/asem.py).

Publication: https://doi.org/10.1083/jcb.202208005. The data is hosted as a
quilt bucket at https://open.quiltdata.com/b/asem-project; downloading
requires the optional ``quilt3`` package.
"""

import os
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import ConcatDataset, DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

# Volumes cell_8/14/15/16/17 have no labels. Some (volume, organelle) pairs
# have label volumes whose shape differs from the raw shape; they are fixed
# up by cropping the raw to the label offset (see _make_volumes_consistent).
INCONSISTENT_VOLUMES = {
    "mito": ["cell_6.zarr", "cell_13.zarr", "cell_13a.zarr"],
    "golgi": ["cell_3.zarr", "cell_6.zarr"],
    "er": ["cell_3.zarr", "cell_6.zarr", "cell_13.zarr"],
}

VOLUMES = {
    "cell_1": "cell_1/cell_1.zarr",
    "cell_2": "cell_2/cell_2.zarr",
    "cell_3": "cell_3/cell_3.zarr",
    "cell_6": "cell_6/cell_6.zarr",
    "cell_12": "cell_12/cell_12.zarr",
    "cell_13": "cell_13/cell_13.zarr",
    "cell_13a": "cell_13a/cell_13a.zarr",
}

ORGANELLES = {
    "mito": ["cell_1", "cell_2", "cell_3", "cell_6", "cell_13", "cell_13a"],
    "golgi": ["cell_1", "cell_2", "cell_3", "cell_6"],
    "er": ["cell_1", "cell_2", "cell_3", "cell_6"],
    "ccp": ["cell_12", "cell_13"],
    "np": ["cell_13a"],
    "np_bottom": ["cell_13a"],
}


def get_asem_data(path: Union[os.PathLike, str], volume_ids: List[str], download: bool = False):
    """Download ASEM volumes (raw + labels zarr groups) from the quilt bucket."""
    try:
        import quilt3 as q3
        have_quilt = True
    except ImportError:
        have_quilt = False

    if download and not have_quilt:
        raise ModuleNotFoundError("Please install quilt3: 'pip install quilt3'.")

    for volume_id in volume_ids:
        volume_path = os.path.join(str(path), VOLUMES[volume_id])
        if os.path.exists(volume_path):
            continue
        if not download:
            raise FileNotFoundError(f"{VOLUMES[volume_id]} is not found, and 'download' is set to False.")
        b = q3.Bucket("s3://asem-project")
        b.fetch(key=f"datasets/{VOLUMES[volume_id]}/volumes/labels/",
                path=os.path.join(volume_path, "volumes", "labels/"))
        b.fetch(key=f"datasets/{VOLUMES[volume_id]}/volumes/raw/",
                path=os.path.join(volume_path, "volumes", "raw/"))
        b.fetch(key=f"datasets/{VOLUMES[volume_id]}/.zgroup", path=f"{volume_path}/")
        b.fetch(key=f"datasets/{VOLUMES[volume_id]}/volumes/.zgroup", path=f"{volume_path}/volumes/")


def get_asem_paths(path: Union[os.PathLike, str], volume_ids: List[str],
                   download: bool = False) -> List[str]:
    """Get paths to the ASEM zarr volumes."""
    get_asem_data(path, volume_ids, download)
    return [os.path.join(str(path), VOLUMES[vol_id]) for vol_id in volume_ids]


def _make_volumes_consistent(volume_path, organelle):
    """Crop raw to the label bounding box for volumes whose label shape differs;
    stores the crop as ``volumes/raw_<organelle>`` inside the zarr group.

    Uses the port's own zarr reader and writer (``utils/zarr_n5.py``) plus the zarr-v2
    on-disk ``.zattrs`` JSON for the offset/resolution metadata, so no zarr-python is required."""
    import json

    from ....utils.io import load_data, write_data

    volume_name = os.path.split(volume_path)[-1]
    inc_vols = INCONSISTENT_VOLUMES.get(organelle)
    if inc_vols is None or volume_name not in inc_vols:
        return False

    if os.path.exists(os.path.join(volume_path, "volumes", f"raw_{organelle}")):
        return True

    raw = np.asarray(load_data(volume_path, "volumes/raw")[:])
    labels = np.asarray(load_data(volume_path, f"volumes/labels/{organelle}")[:])
    if labels.shape == raw.shape:
        return False

    def _attrs(key):
        with open(os.path.join(volume_path, *key.split("/"), ".zattrs")) as f:
            return json.load(f)

    raw_attrs = _attrs("volumes/raw")
    label_attrs = _attrs(f"volumes/labels/{organelle}")
    img_offset = np.array(raw_attrs["offset"]) // np.array(raw_attrs["resolution"])
    label_offset = np.array(label_attrs["offset"]) // np.array(label_attrs["resolution"])
    offset = label_offset - img_offset
    bb = tuple(slice(int(o), int(o + s)) for o, s in zip(offset, labels.shape))
    new_raw = raw[bb]
    assert new_raw.shape == labels.shape
    write_data(volume_path, f"volumes/raw_{organelle}", new_raw, chunks=new_raw.shape)
    return True


def _check_input_args(input_arg, default_values):
    if input_arg is None:
        return list(default_values)
    if isinstance(input_arg, str):
        assert input_arg in default_values
        return [input_arg]
    return input_arg


def get_asem_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                     download: bool = False,
                     organelles: Optional[Union[List[str], str]] = None,
                     volume_ids: Optional[Union[List[str], str]] = None, **kwargs):
    """Dataset for organelle segmentation in FIB-SEM cells."""
    organelles = _check_input_args(organelles, ORGANELLES)

    all_datasets = []
    for organelle in organelles:
        if volume_ids is None:
            vol_ids = ORGANELLES[organelle]
        else:
            vol_ids = [volume_ids] if isinstance(volume_ids, str) else volume_ids
            for volume_id in vol_ids:
                assert volume_id in ORGANELLES[organelle], \
                    f"The chosen volume and organelle combination does not match: '{volume_id}' & '{organelle}'"

        volume_paths = get_asem_paths(path, vol_ids, download)
        for volume_path in volume_paths:
            inconsistent = _make_volumes_consistent(volume_path, organelle)
            dataset = default_segmentation_dataset(
                raw_paths=volume_path,
                raw_key=f"volumes/raw_{organelle}" if inconsistent else "volumes/raw",
                label_paths=volume_path,
                label_key=f"volumes/labels/{organelle}",
                patch_shape=patch_shape,
                is_seg_dataset=True,
                **kwargs,
            )
            dataset.max_sampling_attempts = 5000
            all_datasets.append(dataset)

    return ConcatDataset(*all_datasets)


def get_asem_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                    batch_size: int, download: bool = False,
                    organelles: Optional[Union[List[str], str]] = None,
                    volume_ids: Optional[Union[List[str], str]] = None, **kwargs) -> DataLoader:
    """DataLoader for organelle segmentation in FIB-SEM cells."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_asem_dataset(path, patch_shape, download, organelles, volume_ids, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
