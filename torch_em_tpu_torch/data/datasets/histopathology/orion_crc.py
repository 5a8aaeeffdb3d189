"""ORION-CRC: paired H&E and multiplex immunofluorescence tiles of colorectal
cancer tissue with Cellpose nucleus instance masks and derived cell-type
semantic labels (reference torch_em/data/datasets/histopathology/orion_crc.py).

Supports the processed tile release from MIPHEI-ViT
(https://zenodo.org/records/15340874, ~127 GB); the source ORION-CRC dataset
is https://zenodo.org/records/7637988 / https://doi.org/10.1038/s43018-023-00576-1.
Per-slide h5 layout: ``raw/he`` (3, N, H, W), ``raw/mif`` (C, N, H, W),
``labels/nucleus/instances`` and (when per-cell CSVs exist)
``labels/nucleus/semantic`` (N, H, W); class ids recorded in
``semantic_label_mapping.csv``.
"""

import os
import re
from glob import glob
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util

URL = "https://zenodo.org/api/records/15340874/files/ORIONCRC_dataset_tile_20x.zip/content"
ZIP_NAME = "ORIONCRC_dataset_tile_20x.zip"
SPLITS = ("train", "val", "test")

CELL_TYPE_COLUMNS = ("cell_type", "celltype", "cell_type_pred", "predicted_cell_type", "phenotype", "class", "label")
X_COLUMNS = ("x", "X", "centroid_x", "nucleus_x", "nuclei_x", "center_x")
Y_COLUMNS = ("y", "Y", "centroid_y", "nucleus_y", "nuclei_y", "center_y")
TILE_X_COLUMNS = ("tile_x", "x_start", "xmin", "min_x", "left")
TILE_Y_COLUMNS = ("tile_y", "y_start", "ymin", "min_y", "top")


def _find_file(path, name):
    matches = glob(os.path.join(str(path), "**", name), recursive=True)
    return sorted(matches)[0] if matches else None


def _resolve_path(root, metadata_path, value):
    value = str(value)
    for candidate in (os.path.join(os.path.dirname(metadata_path), value),
                      os.path.join(str(root), value), value):
        if os.path.exists(candidate):
            return candidate
    return os.path.join(os.path.dirname(metadata_path), value)


def _find_column(columns, candidates):
    lower_to_column = {c.lower(): c for c in columns}
    for candidate in candidates:
        if candidate.lower() in lower_to_column:
            return lower_to_column[candidate.lower()]
    return None


def _get_metadata(root, split):
    import pandas as pd

    metadata_path = _find_file(root, f"{split}_dataframe.csv")
    if metadata_path is None:
        raise RuntimeError(f"Could not find {split}_dataframe.csv in {root}.")
    return metadata_path, pd.read_csv(metadata_path)


def _get_slide_csv_paths(root):
    import pandas as pd

    slide_df_path = _find_file(root, "slide_dataframe.csv")
    if slide_df_path is None:
        return {}
    slide_df = pd.read_csv(slide_df_path)
    name_col = _find_column(slide_df.columns, ["slide_name", "in_slide_name"])
    if name_col is None or "nuclei_csv_path" not in slide_df.columns:
        return {}
    return {row[name_col]: _resolve_path(root, slide_df_path, row["nuclei_csv_path"])
            for _, row in slide_df.iterrows()}


def _get_slide_id_map(root):
    import pandas as pd

    slide_df_path = _find_file(root, "slide_dataframe.csv")
    if slide_df_path is None:
        return {}
    slide_df = pd.read_csv(slide_df_path)
    name_col = _find_column(slide_df.columns, ["slide_name", "in_slide_name"])
    if name_col is None or "orion_slide_id" not in slide_df.columns:
        return {}
    return dict(zip(slide_df[name_col], slide_df["orion_slide_id"]))


def _parse_tile_origin(path):
    stem = os.path.splitext(os.path.basename(path))[0]
    numbers = [int(n) for n in re.findall(r"\d+", stem)]
    # tile filenames follow *_x_y_z_width_height.*, so origin is at [-5], [-4]
    if len(numbers) >= 5:
        return numbers[-5], numbers[-4]
    return None


def _get_tile_origin(row, image_path):
    x_col = _find_column(row.index, TILE_X_COLUMNS)
    y_col = _find_column(row.index, TILE_Y_COLUMNS)
    if x_col is not None and y_col is not None:
        return int(row[x_col]), int(row[y_col])
    return _parse_tile_origin(image_path)


def _read_image(path):
    image = np.asarray(load_image(path))
    if image.ndim == 3:
        image = image.transpose(2, 0, 1)
    return image


def _read_label(path):
    label = np.asarray(load_image(path))
    if label.ndim == 3:
        label = label[..., 0]
    return label


def _collect_cell_tables(root):
    import pandas as pd

    return {name: pd.read_csv(csv_path)
            for name, csv_path in _get_slide_csv_paths(root).items()
            if os.path.exists(csv_path)}


def _infer_cell_columns(cell_tables):
    if not cell_tables:
        return None
    first = next(iter(cell_tables.values()))
    cols = (_find_column(first.columns, CELL_TYPE_COLUMNS),
            _find_column(first.columns, X_COLUMNS),
            _find_column(first.columns, Y_COLUMNS))
    return None if any(c is None for c in cols) else cols


def _get_cell_type_mapping(cell_tables, cell_type_column):
    cell_types = set()
    for table in cell_tables.values():
        cell_types.update(str(v) for v in table[cell_type_column].dropna().unique())
    return {ct: i for i, ct in enumerate(sorted(cell_types), start=1)}


def _write_cell_type_mapping(output_root, mapping):
    import pandas as pd

    mapping_path = os.path.join(output_root, "semantic_label_mapping.csv")
    if os.path.exists(mapping_path):
        return
    os.makedirs(output_root, exist_ok=True)
    pd.DataFrame([{"label_id": i, "cell_type": ct} for ct, i in mapping.items()]
                 ).to_csv(mapping_path, index=False)


def _make_semantic_label_from_instances(row, image_path, nuclei, cell_table,
                                        cell_type_mapping, cell_columns):
    """Assign each nucleus instance the cell type of the CSV cell at its
    coordinates (tile-local first, raw coordinates as fallback)."""
    cell_type_column, x_column, y_column = cell_columns
    origin = _get_tile_origin(row, image_path)
    tile_h, tile_w = nuclei.shape

    cells = cell_table[cell_table[cell_type_column].notna()]
    if len(cells) == 0:
        return np.zeros(nuclei.shape, dtype="uint16")
    xs = cells[x_column].to_numpy(dtype=float)
    ys = cells[y_column].to_numpy(dtype=float)
    class_ids = np.array([cell_type_mapping[str(v)] for v in cells[cell_type_column]], dtype="uint16")

    inst_ids = np.zeros(len(xs), dtype=nuclei.dtype)
    if origin is not None:
        lx = np.round(xs - origin[0]).astype(int)
        ly = np.round(ys - origin[1]).astype(int)
        in_bounds = (lx >= 0) & (lx < tile_w) & (ly >= 0) & (ly < tile_h)
        inst_ids[in_bounds] = nuclei[ly[in_bounds], lx[in_bounds]]
        needs_fallback = ~in_bounds | (inst_ids == 0)
        if needs_fallback.any():
            lx_raw, ly_raw = np.round(xs).astype(int), np.round(ys).astype(int)
            fb = needs_fallback & (lx_raw >= 0) & (lx_raw < tile_w) & (ly_raw >= 0) & (ly_raw < tile_h)
            inst_ids[fb] = nuclei[ly_raw[fb], lx_raw[fb]]
    else:
        lx, ly = np.round(xs).astype(int), np.round(ys).astype(int)
        in_bounds = (lx >= 0) & (lx < tile_w) & (ly >= 0) & (ly < tile_h)
        inst_ids[in_bounds] = nuclei[ly[in_bounds], lx[in_bounds]]

    hit = inst_ids > 0
    if not hit.any():
        return np.zeros(nuclei.shape, dtype="uint16")
    inst_to_class = np.zeros(int(nuclei.max()) + 1, dtype="uint16")
    inst_to_class[inst_ids[hit]] = class_ids[hit]
    return inst_to_class[nuclei]


def _preprocess_slide(root, metadata_path, slide_name, group, output_path,
                      cell_tables, cell_columns, cell_type_mapping):
    h5py = _h5py()

    if os.path.exists(output_path):
        return

    has_cell_table = cell_columns is not None and slide_name in cell_tables
    tmp_path = output_path + ".tmp"
    n, N = 0, len(group)
    tile_h = tile_w = None
    he_ds = mif_ds = inst_ds = sem_ds = None

    with h5py.File(tmp_path, "w") as f:
        f.attrs["slide_name"] = slide_name
        for _, row in group.iterrows():
            he_path = _resolve_path(root, metadata_path, row["image_path"])
            mif_path = _resolve_path(root, metadata_path, row["target_path"])
            nucleus_path = _resolve_path(root, metadata_path, row["nuclei_path"])
            if not all(os.path.exists(p) for p in (he_path, mif_path, nucleus_path)):
                continue

            he, mif, nuclei = _read_image(he_path), _read_image(mif_path), _read_label(nucleus_path)
            if he.ndim == 2:
                he = he[None]
            if tile_h is None:
                tile_h, tile_w = he.shape[-2:]
            elif he.shape[-2:] != (tile_h, tile_w):
                continue
            if mif.ndim == 2:
                mif = mif[None]

            if he_ds is None:
                C_he, C_mif = he.shape[0], mif.shape[0]
                he_ds = f.create_dataset("raw/he", shape=(C_he, N, tile_h, tile_w),
                                         maxshape=(C_he, None, tile_h, tile_w), compression="lzf",
                                         chunks=(C_he, 1, tile_h, tile_w), dtype=he.dtype)
                mif_ds = f.create_dataset("raw/mif", shape=(C_mif, N, tile_h, tile_w),
                                          maxshape=(C_mif, None, tile_h, tile_w), compression="lzf",
                                          chunks=(C_mif, 1, tile_h, tile_w), dtype=mif.dtype)
                inst_ds = f.create_dataset("labels/nucleus/instances", shape=(N, tile_h, tile_w),
                                           maxshape=(None, tile_h, tile_w), compression="lzf",
                                           chunks=(1, tile_h, tile_w), dtype=nuclei.dtype)
                if has_cell_table:
                    sem_ds = f.create_dataset("labels/nucleus/semantic", shape=(N, tile_h, tile_w),
                                              maxshape=(None, tile_h, tile_w), compression="lzf",
                                              chunks=(1, tile_h, tile_w), dtype="uint16")

            he_ds[:, n] = he
            mif_ds[:, n] = mif
            inst_ds[n] = nuclei
            if has_cell_table and sem_ds is not None:
                sem_ds.resize(n + 1, axis=0)
                sem_ds[n] = _make_semantic_label_from_instances(
                    row, he_path, nuclei, cell_tables[slide_name], cell_type_mapping, cell_columns)
            n += 1

        if he_ds is not None and n < N:
            he_ds.resize(n, axis=1)
            mif_ds.resize(n, axis=1)
            inst_ds.resize(n, axis=0)
            if sem_ds is not None:
                sem_ds.resize(n, axis=0)

    if n == 0:
        os.remove(tmp_path)
        return
    os.rename(tmp_path, output_path)


def _preprocess_split(root, split, preprocessing_workers=8):
    metadata_path, metadata = _get_metadata(root, split)
    missing = {"image_path", "target_path", "nuclei_path"} - set(metadata.columns)
    if missing:
        raise RuntimeError(f"Missing columns in {metadata_path}: {sorted(missing)}.")

    output_root = os.path.join(str(root), "preprocessed", "orion_crc")
    split_root = os.path.join(output_root, split)
    os.makedirs(split_root, exist_ok=True)

    slide_id_map = _get_slide_id_map(root)
    cell_tables = _collect_cell_tables(root)
    cell_columns = _infer_cell_columns(cell_tables)
    cell_type_mapping = None
    if cell_columns is not None:
        cell_type_mapping = _get_cell_type_mapping(cell_tables, cell_columns[0])
        _write_cell_type_mapping(output_root, cell_type_mapping)

    slide_name_col = _find_column(metadata.columns, ["slide_name", "in_slide_name"])
    if slide_name_col is None:
        raise RuntimeError(f"Could not find slide name column in {metadata_path}.")

    tasks = []
    for slide_name, group in metadata.groupby(slide_name_col):
        slide_id = slide_id_map.get(slide_name, slide_name.split(".")[0])
        output_path = os.path.join(split_root, f"{slide_id}.h5")
        tasks.append((root, metadata_path, slide_name, group, output_path,
                      cell_tables, cell_columns, cell_type_mapping))

    n_workers = min(preprocessing_workers, len(tasks))
    if n_workers > 1:
        from multiprocessing import Pool

        with Pool(n_workers) as pool:
            pool.starmap(_preprocess_slide, tasks)
    else:
        for args in tasks:
            _preprocess_slide(*args)
    return output_root


def get_orion_crc_data(path: Union[os.PathLike, str], split: Optional[str] = None,
                       download: bool = False, preprocessing_workers: int = 8) -> str:
    """Download (127 GB) / locate and preprocess the ORION-CRC tile data."""
    os.makedirs(str(path), exist_ok=True)
    if _find_file(path, "train_dataframe.csv") is None:
        zip_path = os.path.join(str(path), ZIP_NAME)
        if os.path.exists(zip_path):
            util.unzip(zip_path, str(path), remove=False)
        elif download:
            util.download_source(zip_path, URL, download=download, checksum=None)
            util.unzip(zip_path, str(path), remove=False)
        else:
            raise RuntimeError(
                f"Could not find the processed ORION-CRC data in {path}. Please download "
                f"{ZIP_NAME} from https://zenodo.org/records/15340874 and extract it there, "
                "or pass download=True to download the 127 GB archive.")

    output_root = None
    for this_split in (SPLITS if split is None else (split,)):
        output_root = _preprocess_split(path, this_split, preprocessing_workers=preprocessing_workers)
    return output_root


def get_orion_crc_paths(path: Union[os.PathLike, str], split: str,
                        download: bool = False, preprocessing_workers: int = 8) -> List[str]:
    """Per-slide preprocessed h5 paths for a split."""
    if split not in SPLITS:
        raise ValueError(f"'{split}' is not a valid split choice. Choose from {SPLITS}.")
    output_root = get_orion_crc_data(path, split=split, download=download,
                                     preprocessing_workers=preprocessing_workers)
    paths = sorted(glob(os.path.join(output_root, split, "*.h5")))
    if not paths:
        raise RuntimeError("Could not find any preprocessed ORION-CRC slides for the requested settings.")
    return paths


def get_orion_crc_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          split: str, modality: str = "he", label_type: str = "instances",
                          download: bool = False, resize_inputs: bool = False,
                          preprocessing_workers: int = 8, **kwargs):
    """Dataset for nucleus instance/semantic segmentation over ORION-CRC tiles."""
    if modality not in ("he", "mif"):
        raise ValueError(f"'{modality}' is not a valid modality. Choose from 'he' or 'mif'.")
    if label_type not in ("instances", "semantic"):
        raise ValueError(f"'{label_type}' is not a valid label type. Choose from 'instances' or 'semantic'.")

    paths = get_orion_crc_paths(path, split, download, preprocessing_workers=preprocessing_workers)

    if label_type == "semantic":
        output_root = os.path.dirname(os.path.dirname(paths[0]))
        if not os.path.exists(os.path.join(output_root, "semantic_label_mapping.csv")):
            raise RuntimeError("Semantic labels are not available for this ORION-CRC data.")

    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": modality == "he"}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs=kwargs, patch_shape=patch_shape, resize_inputs=resize_inputs,
            resize_kwargs=resize_kwargs)

    # raw is (C, N, H, W), labels (N, H, W): prepend 1 to take one tile at a time
    return default_segmentation_dataset(
        raw_paths=paths, raw_key=f"raw/{modality}",
        label_paths=paths, label_key=f"labels/nucleus/{label_type}",
        is_seg_dataset=True, patch_shape=(1,) + tuple(patch_shape),
        with_channels=True, **kwargs,
    )


def get_orion_crc_loader(path: Union[os.PathLike, str], batch_size: int,
                         patch_shape: Tuple[int, int], split: str,
                         modality: str = "he", label_type: str = "instances",
                         download: bool = False, resize_inputs: bool = False,
                         preprocessing_workers: int = 8, **kwargs) -> DataLoader:
    """DataLoader for nucleus instance/semantic segmentation over ORION-CRC."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_orion_crc_dataset(path, patch_shape, split, modality=modality,
                               label_type=label_type, download=download,
                               resize_inputs=resize_inputs,
                               preprocessing_workers=preprocessing_workers, **ds_kwargs)
    return get_data_loader(ds, batch_size, **loader_kwargs)
