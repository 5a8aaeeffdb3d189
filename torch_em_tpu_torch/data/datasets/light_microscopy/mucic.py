"""MUCIC (Masaryk University Cell Image Collection): mostly synthetic 3D
microscopy benchmarks for cell/nucleus segmentation (reference
torch_em/data/datasets/light_microscopy/mucic.py).

Cell lines: colon_tissue (semantic), hl60 (instances), granulocytes
(instances), vasculogenesis (2D time-lapse, semantic), mda231 (CTC
Fluo-C3DL-MDA231 with ISBI 2025 full annotations). Data at
https://cbia.fi.muni.cz/datasets/; cite the per-dataset publications.
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py
from .. import util

URLS = {
    "colon_tissue": {
        "low": "https://datasets.gryf.fi.muni.cz/iciar2011/ColonTissue_LowNoise_3D_HDF5.zip",
        "high": "https://datasets.gryf.fi.muni.cz/iciar2011/ColonTissue_HighNoise_3D_HDF5.zip",
    },
    "hl60": {
        "low_c00": "https://datasets.gryf.fi.muni.cz/cytometry2009/HL60_LowNoise_C00_3D_HDF5.zip",
        "low_c25": "https://datasets.gryf.fi.muni.cz/cytometry2009/HL60_LowNoise_C25_3D_HDF5.zip",
        "low_c50": "https://datasets.gryf.fi.muni.cz/cytometry2009/HL60_LowNoise_C50_3D_HDF5.zip",
        "low_c75": "https://datasets.gryf.fi.muni.cz/cytometry2009/HL60_LowNoise_C75_3D_HDF5.zip",
        "high_c00": "https://datasets.gryf.fi.muni.cz/cytometry2009/HL60_HighNoise_C00_3D_HDF5.zip",
        "high_c25": "https://datasets.gryf.fi.muni.cz/cytometry2009/HL60_HighNoise_C25_3D_HDF5.zip",
        "high_c50": "https://datasets.gryf.fi.muni.cz/cytometry2009/HL60_HighNoise_C50_3D_HDF5.zip",
        "high_c75": "https://datasets.gryf.fi.muni.cz/cytometry2009/HL60_HighNoise_C75_3D_HDF5.zip",
    },
    "granulocytes": {
        "low": "https://datasets.gryf.fi.muni.cz/cytometry2009/Granulocytes_LowNoise_3D_HDF5.zip",
        "high": "https://datasets.gryf.fi.muni.cz/cytometry2009/Granulocytes_HighNoise_3D_HDF5.zip",
    },
    "vasculogenesis": {
        "default": {
            "images": "https://datasets.gryf.fi.muni.cz/icip2016/vasculogenesis-images.zip",
            "labels": "https://datasets.gryf.fi.muni.cz/icip2016/vasculogenesis-labels.zip",
        },
    },
    "mda231": {
        "default": {
            "images": "https://data.celltrackingchallenge.net/training-datasets/Fluo-C3DL-MDA231.zip",
            "labels": "https://datasets.gryf.fi.muni.cz/isbi2025/Fluo-C3DL-MDA231_Full_Annotations.zip",
        },
    },
}

CELL_LINES = list(URLS.keys())

# semantic labels need connected components / watershed for instances
_SEMANTIC_LABEL_CELL_LINES = ["colon_tissue", "vasculogenesis"]
# separate image/label zip files
_SEPARATE_ZIPS_CELL_LINES = ["vasculogenesis", "mda231"]
# 2D cell lines (others are 3D)
_2D_CELL_LINES = ["vasculogenesis"]


def _write_h5(out_path, raw, instances, semantic):
    h5py = _h5py()

    with h5py.File(out_path, "w") as f:
        f.create_dataset("raw", data=raw, compression="gzip")
        f.create_dataset("labels/instances", data=instances, compression="gzip")
        f.create_dataset("labels/semantic", data=semantic, compression="gzip")


def _create_mucic_h5(path, cell_line, variant):
    """Process paired image-final_*/image-labels_* h5 files (key 'Image')."""
    h5py = _h5py()

    from ....ops.host import connected_components

    data_dir = os.path.join(str(path), cell_line, variant)
    h5_out_dir = os.path.join(str(path), cell_line, "processed", variant)
    os.makedirs(h5_out_dir, exist_ok=True)

    raw_files = sorted(glob(os.path.join(data_dir, "**", "image-final_*.h5"), recursive=True))
    if not raw_files:
        raw_files = sorted(glob(os.path.join(data_dir, "**", "image-final_*.hdf5"), recursive=True))

    for raw_path in raw_files:
        label_path = raw_path.replace("image-final_", "image-labels_")
        if not os.path.exists(label_path):
            continue
        fname = os.path.basename(raw_path)
        out_path = os.path.join(
            h5_out_dir, fname.replace("image-final_", f"{cell_line}_").replace(".hdf5", ".h5"))
        if os.path.exists(out_path):
            continue
        with h5py.File(raw_path, "r") as f:
            raw = f["Image"][:]
        with h5py.File(label_path, "r") as f:
            labels = f["Image"][:]
        if cell_line in _SEMANTIC_LABEL_CELL_LINES:
            instances = connected_components(labels > 0).astype("int64")
        else:
            instances = labels.astype("int64")
        _write_h5(out_path, raw, instances, (labels > 0).astype("uint8"))
    return h5_out_dir


def _semantic_to_instances_watershed(semantic_mask, erosion_iterations=2):
    """Semantic mask -> instances via erosion + seeded watershed on the EDT,
    separating cells that touch by a few pixels."""
    from ....ops import native
    from ....ops.host import binary_erosion, connected_components, distance_transform

    binary_mask = semantic_mask > 0
    eroded = binary_erosion(binary_mask, iterations=erosion_iterations)
    seeds = connected_components(eroded).astype("uint32")
    distance = distance_transform(binary_mask)
    instances = native.watershed((-distance).astype("float32"), seeds, mask=binary_mask)
    return instances.astype("int64")


def _create_vasculogenesis_h5(path, variant):
    """Process vasculogenesis image_XXXX.png / mask_XXXX.png pairs."""
    from ....utils.io import load_image

    data_dir = os.path.join(str(path), "vasculogenesis", variant)
    h5_out_dir = os.path.join(str(path), "vasculogenesis", "processed", variant)
    os.makedirs(h5_out_dir, exist_ok=True)

    for raw_path in sorted(glob(os.path.join(data_dir, "images", "**", "image_*.png"), recursive=True)):
        fname = os.path.basename(raw_path)
        label_path = os.path.join(data_dir, "labels", fname.replace("image_", "mask_"))
        if not os.path.exists(label_path):
            # labels may be nested one level deeper after unzip
            candidates = glob(os.path.join(data_dir, "labels", "**",
                                           fname.replace("image_", "mask_")), recursive=True)
            if not candidates:
                continue
            label_path = candidates[0]
        file_id = fname.replace("image_", "").replace(".png", "")
        out_path = os.path.join(h5_out_dir, f"vasculogenesis_{file_id}.h5")
        if os.path.exists(out_path):
            continue
        raw = np.asarray(load_image(raw_path))
        labels_data = np.asarray(load_image(label_path))
        instances = _semantic_to_instances_watershed(labels_data)
        _write_h5(out_path, raw, instances, (labels_data > 0).astype("uint8"))
    return h5_out_dir


def _create_mda231_h5(path, variant):
    """Process MDA231 CTC tiffs (t*.tif) with full annotations (man_seg_full*.tif)."""
    from ....utils.io import load_image

    data_dir = os.path.join(str(path), "mda231", variant)
    h5_out_dir = os.path.join(str(path), "mda231", "processed", variant)
    os.makedirs(h5_out_dir, exist_ok=True)

    images_base = os.path.join(data_dir, "images", "Fluo-C3DL-MDA231")
    labels_base = os.path.join(data_dir, "labels", "Fluo-C3DL-MDA231_Full_Annotations")
    seq_to_labels = {
        "01": os.path.join(labels_base, "S01_FA_MV", "S01_FA_A1"),
        "02": os.path.join(labels_base, "S02_FA_A1"),
    }

    for seq_id, labels_dir in seq_to_labels.items():
        images_dir = os.path.join(images_base, seq_id)
        if not os.path.exists(images_dir) or not os.path.exists(labels_dir):
            continue
        for raw_path in sorted(glob(os.path.join(images_dir, "t*.tif"))):
            time_id = os.path.basename(raw_path).replace(".tif", "").replace("t", "")
            label_path = os.path.join(labels_dir, f"man_seg_full{time_id}.tif")
            if not os.path.exists(label_path):
                continue
            out_path = os.path.join(h5_out_dir, f"mda231_{seq_id}_{time_id}.h5")
            if os.path.exists(out_path):
                continue
            raw = np.asarray(load_image(raw_path))
            labels = np.asarray(load_image(label_path)).astype("int64")
            _write_h5(out_path, raw, labels, (labels > 0).astype("uint8"))
    return h5_out_dir


def get_mucic_data(path: Union[os.PathLike, str], cell_line: str,
                   variant: Optional[Union[str, List[str]]] = None,
                   download: bool = False) -> str:
    """Download the MUCIC archives for a cell line (all variants if None)."""
    assert cell_line in CELL_LINES, f"'{cell_line}' is not valid. Choose from {CELL_LINES}."
    valid_variants = list(URLS[cell_line].keys())
    if variant is None:
        variant = valid_variants
    elif isinstance(variant, str):
        variant = [variant]

    for v in variant:
        assert v in valid_variants, f"'{v}' is not valid for '{cell_line}'. Choose from {valid_variants}."
        data_dir = os.path.join(str(path), cell_line, v)
        file_pattern = {"mda231": "*.tif", "vasculogenesis": "*.png"}.get(cell_line, "*.h5")
        if os.path.exists(data_dir) and len(glob(os.path.join(data_dir, "**", file_pattern), recursive=True)) > 0:
            continue
        os.makedirs(data_dir, exist_ok=True)
        if cell_line in _SEPARATE_ZIPS_CELL_LINES:
            urls = URLS[cell_line][v]
            images_zip = os.path.join(str(path), f"{cell_line}_{v}_images.zip")
            util.download_source(path=images_zip, url=urls["images"], download=download, checksum=None)
            util.unzip(zip_path=images_zip, dst=os.path.join(data_dir, "images"), remove=False)
            labels_zip = os.path.join(str(path), f"{cell_line}_{v}_labels.zip")
            util.download_source(path=labels_zip, url=urls["labels"], download=download, checksum=None)
            util.unzip(zip_path=labels_zip, dst=os.path.join(data_dir, "labels"), remove=False)
        else:
            zip_path = os.path.join(str(path), f"{cell_line}_{v}.zip")
            util.download_source(path=zip_path, url=URLS[cell_line][v], download=download, checksum=None)
            util.unzip(zip_path=zip_path, dst=data_dir, remove=False)
    return os.path.join(str(path), cell_line)


def get_mucic_paths(path: Union[os.PathLike, str], cell_line: str,
                    variant: Optional[Union[str, List[str]]] = None,
                    download: bool = False) -> List[str]:
    """Paths to the processed MUCIC h5 files for a cell line."""
    assert cell_line in CELL_LINES, f"'{cell_line}' is not valid. Choose from {CELL_LINES}."
    get_mucic_data(path, cell_line, variant, download)

    valid_variants = list(URLS[cell_line].keys())
    if variant is None:
        variant = valid_variants
    elif isinstance(variant, str):
        variant = [variant]

    all_h5_paths = []
    for v in variant:
        h5_out_dir = os.path.join(str(path), cell_line, "processed", v)
        if not os.path.exists(h5_out_dir) or len(glob(os.path.join(h5_out_dir, "*.h5"))) == 0:
            if cell_line == "vasculogenesis":
                _create_vasculogenesis_h5(path, v)
            elif cell_line == "mda231":
                _create_mda231_h5(path, v)
            else:
                _create_mucic_h5(path, cell_line, v)
        all_h5_paths.extend(glob(os.path.join(h5_out_dir, "*.h5")))
    assert len(all_h5_paths) > 0, f"No data found for cell_line '{cell_line}', variant '{variant}'"
    return util.natsorted(all_h5_paths)


def get_mucic_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                      cell_line: str, variant: Optional[Union[str, List[str]]] = None,
                      segmentation_type: str = "instances", download: bool = False,
                      **kwargs):
    """Dataset for cell segmentation over MUCIC ('instances' or 'semantic' labels)."""
    assert segmentation_type in ("instances", "semantic"), \
        f"'{segmentation_type}' is not valid. Choose from 'instances' or 'semantic'."
    h5_paths = get_mucic_paths(path, cell_line, variant, download)
    kwargs, _ = util.add_instance_label_transform(kwargs, add_binary_target=True, label_dtype=np.int64)
    ndim = 2 if cell_line in _2D_CELL_LINES else 3
    return default_segmentation_dataset(
        raw_paths=h5_paths, raw_key="raw",
        label_paths=h5_paths, label_key=f"labels/{segmentation_type}",
        patch_shape=patch_shape, ndim=ndim, **kwargs,
    )


def get_mucic_loader(path: Union[os.PathLike, str], batch_size: int,
                     patch_shape: Tuple[int, ...], cell_line: str,
                     variant: Optional[Union[str, List[str]]] = None,
                     segmentation_type: str = "instances", download: bool = False,
                     **kwargs) -> DataLoader:
    """DataLoader for cell segmentation over MUCIC."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_mucic_dataset(path=path, patch_shape=patch_shape, cell_line=cell_line,
                           variant=variant, segmentation_type=segmentation_type,
                           download=download, **ds_kwargs)
    return get_data_loader(dataset=ds, batch_size=batch_size, **loader_kwargs)
