"""HEST-1k dataset: 1,276 paired H&E WSIs + spatial transcriptomics across 26
organ types (reference torch_em/data/datasets/histopathology/hest.py).

Pre-extracted 224x224 H&E patches at 0.5 um/px with CellViT nucleus instance
masks, Xenium DAPI nucleus masks (Xenium samples), and ST-derived cell-type
semantic labels (Leiden clustering + PanglaoDB marker voting; classes
0=background, 1=Epithelial, 2=Inflammatory, 3=Connective, 4=Neoplastic,
5=Unknown). Hosted at https://huggingface.co/datasets/MahmoodLab/hest (~2 TB;
filter with ``organs``). Publications: Jaume et al. 2024
(https://doi.org/10.48550/arXiv.2406.16192) and arXiv 2604.23481.

Optional deps: huggingface_hub (download); pandas with pyarrow (the Xenium
parquet); scanpy/igraph/leidenalg (semantic labels). The nucleus polygons are
parsed, selected and rasterized by the port's own ``utils/geometry.py``, with no
geopandas, rasterio or shapely.
"""

import json
import os
import zipfile
from glob import glob
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ...base import Dataset
from ....segmentation import get_data_loader
from .. import util
from ....utils import geometry
from ....utils.io import _h5py

HF_REPO = "MahmoodLab/hest"
METADATA_FILENAME = "HEST_v1_3_0.csv"
PANGLAODB_URL = "https://panglaodb.se/markers/PanglaoDB_markers_27_Mar_2020.tsv.gz"

CELL_TYPE_LABELS = {"Epithelial": 1, "Inflammatory": 2, "Connective": 3, "Neoplastic": 4, "Unknown": 5}

LABEL_KEYS = {
    "instances": "labels/instances/h&e",
    "xenium_instances": "labels/instances/xenium",
    "semantic": "labels/semantic/st",
}

# organs present in both HEST-1k and PanNuke
PANNUKE_ORGANS = [
    "Breast", "Colon", "Kidney", "Liver", "Lung", "Ovarian", "Pancreatic", "Prostate", "Skin", "Stomach",
]

EPITHELIAL_KEYWORDS = [
    "acinar", "airway epithelial", "airway goblet", "alveolar type", "alpha cell", "basal cell",
    "beta cell", "cholangiocyte", "ciliated", "clara", "crypt", "delta cell", "ductal",
    "enterocyte", "epithelial", "goblet", "hepatocyte", "keratinocyte", "mesothelial",
    "paneth", "pneumocyte", "proximal tubule", "renal tubule", "squamous", "thyroid",
    "trophoblast", "tuft", "urothelial",
]
INFLAMMATORY_KEYWORDS = [
    "alveolar macrophage", "b cell", "basophil", "dendritic", "eosinophil",
    "innate lymphoid", "lymphocyte", "macrophage", "mast cell", "monocyte",
    "natural killer", "neutrophil", "nk cell", "plasma cell", "regulatory t", "t cell",
]
CONNECTIVE_KEYWORDS = [
    "adipocyte", "chondrocyte", "endothelial", "fibroblast", "mesenchymal",
    "myofibroblast", "osteoblast", "osteoclast", "pericyte", "smooth muscle",
    "stellate", "stromal", "vascular",
]

CANCER_GENES = {
    "ABL1", "AKT1", "ALK", "APC", "ATM", "BRAF", "BRCA1", "BRCA2", "CDH1", "CDKN2A",
    "CTNNB1", "EGFR", "ERBB2", "ESR1", "EZH2", "FBXW7", "FGFR1", "FGFR2", "FGFR3",
    "FLT3", "GATA3", "GNAQ", "GNAS", "HNF1A", "HRAS", "IDH1", "IDH2", "JAK2", "KIT",
    "KRAS", "MAP2K1", "MDM2", "MET", "MLH1", "MSH2", "MSH6", "MTOR", "MYC", "MYCN",
    "NF1", "NF2", "NFE2L2", "NOTCH1", "NOTCH2", "NRAS", "PALB2", "PBRM1", "PIK3CA",
    "PIK3R1", "PMS2", "POLE", "PTCH1", "PTEN", "RB1", "RET", "RNF43", "SETD2", "SF3B1",
    "SMAD4", "SMARCA4", "SMARCB1", "SMO", "STK11", "TERT", "TET2", "TP53", "TSC1",
    "TSC2", "VHL", "BAP1", "CDK12", "CHEK2", "CREBBP", "DNMT3A", "EP300", "FANCD2",
    "KDM5C", "KDM6A", "KEAP1", "MAP3K1", "MUTYH", "NBN", "PDGFRA", "PPP2R1A", "RAD51C",
    "RUNX1", "SDHA", "SDHB", "SDHC", "SDHD", "SUFU", "TP63", "XRCC2", "AXIN1", "AXIN2",
    "BRIP1", "CHD4", "ELOC", "FANCA", "FH", "FLCN", "MRE11", "RAD50", "RAD51B", "RAD51D",
}


def _download_hest(path, sample_ids, include_xenium, include_st):
    try:
        from huggingface_hub import snapshot_download
    except ImportError:
        raise ImportError("huggingface_hub is required to download HEST-1k.")

    patterns = [METADATA_FILENAME]
    for sid in sample_ids:
        patterns += [f"patches/{sid}.h5", f"cellvit_seg/{sid}_cellvit_seg.geojson.zip"]
        if include_xenium:
            patterns += [f"xenium_seg/{sid}_xenium_nucleus_seg.parquet"]
        if include_st:
            patterns += [f"st/{sid}.h5ad"]
    os.makedirs(path, exist_ok=True)
    snapshot_download(repo_id=HF_REPO, repo_type="dataset", local_dir=path, allow_patterns=patterns)


def _load_metadata(path):
    import pandas as pd

    csv_path = os.path.join(path, METADATA_FILENAME)
    if not os.path.exists(csv_path):
        raise RuntimeError(f"Metadata not found at {csv_path}. Run get_hest_data() first.")
    return pd.read_csv(csv_path)


def _filter_sample_ids(path, organs):
    meta = _load_metadata(path)
    if organs is not None:
        meta = meta[meta["organ"].isin(organs)]
    return meta["id"].tolist()


def _unzip_cellvit(zip_path, out_dir):
    if not os.path.exists(zip_path):
        return None
    sample_id = os.path.basename(zip_path).replace("_cellvit_seg.geojson.zip", "")
    extract_dir = os.path.join(out_dir, sample_id)
    if not os.path.exists(extract_dir):
        with zipfile.ZipFile(zip_path, "r") as zf:
            zf.extractall(extract_dir)
    matches = glob(os.path.join(extract_dir, "**", "*.geojson"), recursive=True)
    return matches[0] if matches else None


def _gdf_from_xenium_parquet(parquet_path):
    import pandas as pd

    df = pd.read_parquet(parquet_path)
    geometries = [geometry.from_wkb(wkb) for wkb in df["geometry"].values]
    return geometry.GeoFrame(geometries, {"cell_id": df.index.astype(str)})


def _gdf_from_cellvit_geojson(geojson_path):
    with open(geojson_path) as fh:
        data = json.load(fh)
    geoms = []
    for feat in data:
        geom = geometry.shape(feat["geometry"])
        if isinstance(geom, geometry.MultiPolygon):
            geoms.extend(geom.geoms)
        else:
            geoms.append(geom)
    return geometry.GeoFrame(geoms)


def _window_geometries(cells_gdf, patch_x, patch_y, patch_size, native_scale):
    """Select the nuclei that intersect one patch window (``.cx``: an exact
    intersection with the closed window box, as geopandas' ``.cx``) and map
    them into patch-pixel coordinates (0.5 um/px grid)."""
    span = round(patch_size * native_scale)
    window = cells_gdf.cx[patch_x:patch_x + span, patch_y:patch_y + span]
    if len(window) == 0:
        return None
    geoms = window.geometry.translate(xoff=-patch_x, yoff=-patch_y)
    if native_scale != 1.0:
        geoms = geoms.scale(xfact=1.0 / native_scale, yfact=1.0 / native_scale, origin=(0, 0))
    return geoms


def _burn(geoms, values, patch_size):
    return geometry.rasterize(zip(geoms, values), out_shape=(patch_size, patch_size), fill=0, dtype=np.int32)


def _rasterize_patch_instances(patch_x, patch_y, patch_size, cells_gdf, native_scale=1.0):
    """Instance mask for one patch: each nucleus polygon gets a unique id >= 1.
    native_scale = native WSI pixels per 0.5 um/px patch pixel."""
    geoms = _window_geometries(cells_gdf, patch_x, patch_y, patch_size, native_scale)
    if geoms is None:
        return np.zeros((patch_size, patch_size), dtype=np.int32)
    return _burn(geoms, range(1, len(geoms) + 1), patch_size)


def _rasterize_patch_semantic(patch_x, patch_y, patch_size, cells_gdf, spot_labels,
                              native_scale=1.0, spot_tree=None):
    """Cell-type mask for one patch: each nucleus is burned with the label of
    its nearest ST spot (nearest-neighbor lookup in native WSI coordinates,
    queried on the patch-local centroids mapped back to native space)."""
    from scipy.spatial import cKDTree

    geoms = _window_geometries(cells_gdf, patch_x, patch_y, patch_size, native_scale)
    if geoms is None:
        return np.zeros((patch_size, patch_size), dtype=np.int32)

    if spot_tree is None:
        spot_tree = cKDTree(spot_labels[:, :2])
    # patch-local centroid -> native WSI coordinate, vectorized
    native_xy = geoms.centroid * native_scale
    native_xy += (patch_x, patch_y)
    nearest = spot_tree.query(native_xy)[1]
    return _burn(geoms, spot_labels[nearest, 2].astype(np.int32), patch_size)


def _load_panglaodb(cache_path):
    """Marker-gene table (human rows only) from PanglaoDB, cached on disk."""
    import pandas as pd

    os.makedirs(cache_path, exist_ok=True)
    tsv_path = os.path.join(cache_path, os.path.basename(PANGLAODB_URL))
    if not os.path.exists(tsv_path):
        # panglaodb.se rejects the default urllib UA, so go through requests
        # with a browser UA rather than util.download_source
        import requests

        resp = requests.get(PANGLAODB_URL, headers={"User-Agent": "Mozilla/5.0"}, timeout=120)
        resp.raise_for_status()
        with open(tsv_path, "wb") as fh:
            fh.write(resp.content)
    table = pd.read_csv(tsv_path, sep="\t", usecols=["species", "official gene symbol", "cell type"])
    human = table["species"].str.contains("Hs", na=False)
    return table.loc[human, ["official gene symbol", "cell type"]]


def _cell_type_to_category(cell_type_name: str) -> str:
    name = cell_type_name.lower()
    for kw in EPITHELIAL_KEYWORDS:
        if kw in name:
            return "Epithelial"
    for kw in INFLAMMATORY_KEYWORDS:
        if kw in name:
            return "Inflammatory"
    for kw in CONNECTIVE_KEYWORDS:
        if kw in name:
            return "Connective"
    return "Unknown"


def _compute_cell_type_map(h5ad_path, marker_db, top_n=10, tau_vote=5, top_m=20, tau_cancer=0.25):
    """ST cell-type assignment (arXiv 2604.23481): Leiden clustering + weighted
    marker-gene voting; epithelial clusters with high cancer-gene overlap are
    relabelled Neoplastic. Returns (N, 3) of (x, y, label) per ST spot."""
    try:
        import scanpy as sc
    except ImportError:
        raise ImportError("scanpy is required for HEST semantic labels.")

    adata = sc.read_h5ad(h5ad_path)
    if "pxl_col_in_fullres" not in adata.obs.columns or "pxl_row_in_fullres" not in adata.obs.columns:
        raise ValueError("h5ad missing pxl_col_in_fullres / pxl_row_in_fullres spot coordinates.")

    gene_to_cats: Dict[str, List[str]] = {}
    for gene, ct in zip(marker_db["official gene symbol"], marker_db["cell type"]):
        gene_to_cats.setdefault(gene, []).append(_cell_type_to_category(ct))

    sc.pp.normalize_total(adata, target_sum=1e4)
    sc.pp.log1p(adata)
    sc.pp.pca(adata)
    sc.pp.neighbors(adata)
    sc.tl.leiden(adata, resolution=4.0)
    sc.tl.rank_genes_groups(adata, groupby="leiden", method="wilcoxon")

    cluster_cat: Dict[str, str] = {}
    for cluster in adata.obs["leiden"].unique():
        try:
            top_genes = list(sc.get.rank_genes_groups_df(adata, group=cluster)["names"].iloc[:top_m])
        except Exception:
            cluster_cat[cluster] = "Unknown"
            continue
        votes = {"Epithelial": 0.0, "Inflammatory": 0.0, "Connective": 0.0}
        total_vote = 0.0
        for rank, gene in enumerate(top_genes[:top_n]):
            weight = top_n - rank
            for cat in gene_to_cats.get(gene, []):
                if cat in votes:
                    votes[cat] += weight
                    total_vote += weight
        if total_vote < tau_vote:
            cluster_cat[cluster] = "Unknown"
            continue
        best = max(votes, key=votes.get)
        cluster_cat[cluster] = best
        if best == "Epithelial":
            cancer_overlap = sum(1 for g in top_genes[:top_m] if g in CANCER_GENES)
            if cancer_overlap / top_m > tau_cancer:
                cluster_cat[cluster] = "Neoplastic"

    xs = adata.obs["pxl_col_in_fullres"].values.astype(np.float32)
    ys = adata.obs["pxl_row_in_fullres"].values.astype(np.float32)
    labels = np.array([CELL_TYPE_LABELS[cluster_cat.get(adata.obs["leiden"].iloc[i], "Unknown")]
                       for i in range(adata.n_obs)], dtype=np.float32)
    return np.stack([xs, ys, labels], axis=1)


def _preprocess_sample(patches_h5, cellvit_geojson, xenium_parquet, h5ad_path,
                       marker_db, out_h5, patch_size=224, pixel_size_um=0.5):
    h5py = _h5py()

    native_scale = 0.5 / pixel_size_um  # native WSI px per 0.5 um/px patch px

    with h5py.File(patches_h5, "r") as f:
        img_key = "img" if "img" in f else ("imgs" if "imgs" in f else "images")
        imgs = f[img_key][:]    # (N, H, W, 3) uint8
        coords = f["coords"][:]  # (N, 2) top-left (x, y) native WSI px

    n = len(imgs)
    if n == 0:
        return False

    cellvit_gdf = _gdf_from_cellvit_geojson(cellvit_geojson) \
        if cellvit_geojson is not None and os.path.exists(cellvit_geojson) else None
    xenium_gdf = _gdf_from_xenium_parquet(xenium_parquet) \
        if xenium_parquet is not None and os.path.exists(xenium_parquet) else None

    spot_labels = None
    if h5ad_path is not None and os.path.exists(h5ad_path) and marker_db is not None and xenium_gdf is not None:
        try:
            spot_labels = _compute_cell_type_map(h5ad_path, marker_db)
        except Exception as e:
            print(f"Warning: semantic labels unavailable for {os.path.basename(h5ad_path)}: {e}")

    spot_tree = None
    if spot_labels is not None:
        try:
            from scipy.spatial import cKDTree

            spot_tree = cKDTree(spot_labels[:, :2])
        except ImportError:
            pass

    raw = np.zeros((n, 3, patch_size, patch_size), dtype=np.uint8)
    instances = np.zeros((n, patch_size, patch_size), dtype=np.int32)
    xenium_instances = np.zeros((n, patch_size, patch_size), dtype=np.int32)
    semantic = np.zeros((n, patch_size, patch_size), dtype=np.int32)

    for i, (img, coord) in enumerate(zip(imgs, coords)):
        raw[i] = img[:patch_size, :patch_size, :].transpose(2, 0, 1)
        px, py = int(coord[0]), int(coord[1])
        if cellvit_gdf is not None:
            instances[i] = _rasterize_patch_instances(px, py, patch_size, cellvit_gdf, native_scale)
        if xenium_gdf is not None:
            xenium_instances[i] = _rasterize_patch_instances(px, py, patch_size, xenium_gdf, native_scale)
        if spot_labels is not None and xenium_gdf is not None:
            semantic[i] = _rasterize_patch_semantic(px, py, patch_size, xenium_gdf,
                                                    spot_labels, native_scale, spot_tree)

    chunk_2d = (1, patch_size, patch_size)
    with h5py.File(out_h5, "w") as f:
        f.create_dataset("raw", data=raw, compression="gzip", chunks=(1, 3, patch_size, patch_size))
        f.create_dataset(LABEL_KEYS["instances"], data=instances, compression="gzip", chunks=chunk_2d)
        f.create_dataset(LABEL_KEYS["xenium_instances"], data=xenium_instances, compression="gzip", chunks=chunk_2d)
        f.create_dataset(LABEL_KEYS["semantic"], data=semantic, compression="gzip", chunks=chunk_2d)
    return True


class HESTDataset(Dataset):
    """2D patch dataset over the per-slide HEST h5 files: returns raw
    (3, H, W) float32 in [0, 1] and labels (H, W) int32."""

    def __init__(self, h5_paths: List[str], label_key: str,
                 raw_transform: Optional[Callable] = None,
                 label_transform: Optional[Callable] = None,
                 transform: Optional[Callable] = None,
                 n_samples: Optional[int] = None, seed: Optional[int] = None):
        h5py = _h5py()

        self._label_key = label_key
        self._raw_transform = raw_transform
        self._label_transform = label_transform
        self._transform = transform

        self._index: List[Tuple[str, int]] = []
        for h5_path in h5_paths:
            with h5py.File(h5_path, "r") as f:
                n = f["raw"].shape[0]
            self._index.extend((h5_path, i) for i in range(n))

        if n_samples is not None:
            rng = np.random.default_rng(seed)
            chosen = rng.choice(len(self._index), size=n_samples,
                                replace=n_samples > len(self._index))
            self._index = [self._index[i] for i in chosen]

    def __len__(self):
        return len(self._index)

    def __getitem__(self, idx):
        h5py = _h5py()

        h5_path, patch_idx = self._index[idx]
        with h5py.File(h5_path, "r") as f:
            raw = f["raw"][patch_idx].astype(np.float32) / 255.0
            label = f[self._label_key][patch_idx].astype(np.int32)
        if self._raw_transform is not None:
            raw = self._raw_transform(raw)
        if self._label_transform is not None:
            label = self._label_transform(label)
        if self._transform is not None:
            raw, label = self._transform(raw, label)
        return raw, label


def get_hest_data(path: Union[os.PathLike, str], organs: Optional[List[str]] = None,
                  download: bool = False) -> str:
    """Download + preprocess HEST-1k samples into per-slide h5 files."""
    path = str(path)
    preprocessed_dir = os.path.join(path, "preprocessed")

    if download:
        meta_path = os.path.join(path, METADATA_FILENAME)
        if not os.path.exists(meta_path):
            try:
                from huggingface_hub import hf_hub_download
            except ImportError:
                raise ImportError("huggingface_hub is required to download HEST-1k.")
            hf_hub_download(repo_id=HF_REPO, repo_type="dataset",
                            filename=METADATA_FILENAME, local_dir=path)
        sample_ids = _filter_sample_ids(path, organs)
        include_xenium = not os.path.exists(os.path.join(path, "xenium_seg"))
        include_st = not os.path.exists(os.path.join(path, "st"))
        _download_hest(path, sample_ids, include_xenium=include_xenium, include_st=include_st)
    else:
        sample_ids = [os.path.splitext(os.path.basename(p))[0]
                      for p in glob(os.path.join(path, "patches", "*.h5"))]
        if organs is not None and os.path.exists(os.path.join(path, METADATA_FILENAME)):
            allowed = set(_filter_sample_ids(path, organs))
            sample_ids = [s for s in sample_ids if s in allowed]

    try:
        marker_db = _load_panglaodb(os.path.join(path, "_db_cache"))
    except Exception:
        marker_db = None

    try:
        meta = _load_metadata(path)
        pixel_size_map = dict(zip(meta["id"], meta["pixel_size_um_estimated"].fillna(0.5)))
    except Exception:
        pixel_size_map = {}

    os.makedirs(preprocessed_dir, exist_ok=True)
    cellvit_zip_dir = os.path.join(path, "cellvit_seg")
    cellvit_cache = os.path.join(path, "_cellvit_extracted")
    xenium_dir = os.path.join(path, "xenium_seg")
    st_dir = os.path.join(path, "st")

    for sid in sample_ids:
        out_h5 = os.path.join(preprocessed_dir, f"{sid}.h5")
        if os.path.exists(out_h5):
            continue
        patches_h5 = os.path.join(path, "patches", f"{sid}.h5")
        if not os.path.exists(patches_h5):
            continue
        geojson_path = _unzip_cellvit(
            os.path.join(cellvit_zip_dir, f"{sid}_cellvit_seg.geojson.zip"), cellvit_cache)
        xenium_parquet = os.path.join(xenium_dir, f"{sid}_xenium_nucleus_seg.parquet")
        h5ad_path = os.path.join(st_dir, f"{sid}.h5ad")
        _preprocess_sample(
            patches_h5=patches_h5, cellvit_geojson=geojson_path,
            xenium_parquet=xenium_parquet if os.path.exists(xenium_parquet) else None,
            h5ad_path=h5ad_path if os.path.exists(h5ad_path) else None,
            marker_db=marker_db, out_h5=out_h5,
            pixel_size_um=float(pixel_size_map.get(sid, 0.5)),
        )
    return preprocessed_dir


def get_hest_paths(path: Union[os.PathLike, str], organs: Optional[List[str]] = None,
                   download: bool = False) -> List[str]:
    """Per-slide preprocessed h5 paths, optionally filtered by organ."""
    preprocessed_dir = get_hest_data(path, organs, download)
    h5_paths = util.natsorted(glob(os.path.join(preprocessed_dir, "*.h5")))
    if not h5_paths:
        raise RuntimeError(f"No preprocessed data found in {preprocessed_dir}.")
    if organs is not None and os.path.exists(os.path.join(str(path), METADATA_FILENAME)):
        allowed = set(_filter_sample_ids(str(path), organs))
        h5_paths = [p for p in h5_paths if os.path.splitext(os.path.basename(p))[0] in allowed]
    return h5_paths


def get_hest_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     organs: Optional[List[str]] = None, label_choice: str = "instances",
                     download: bool = False, n_samples: Optional[int] = None,
                     seed: Optional[int] = None, raw_transform: Optional[Callable] = None,
                     label_transform: Optional[Callable] = None,
                     transform: Optional[Callable] = None) -> Dataset:
    """Dataset for nuclei segmentation / cell-type classification over HEST-1k
    (patches are already 224x224; patch_shape kept for API consistency)."""
    valid = ("instances", "xenium_instances", "semantic")
    if label_choice not in valid:
        raise ValueError(f"'{label_choice}' is not valid. Choose from {valid}.")
    h5_paths = get_hest_paths(path, organs, download)
    return HESTDataset(h5_paths=h5_paths, label_key=LABEL_KEYS[label_choice],
                       raw_transform=raw_transform, label_transform=label_transform,
                       transform=transform, n_samples=n_samples, seed=seed)


def get_hest_loader(path: Union[os.PathLike, str], batch_size: int,
                    patch_shape: Tuple[int, int], organs: Optional[List[str]] = None,
                    label_choice: str = "instances", download: bool = False,
                    n_samples: Optional[int] = None, seed: Optional[int] = None,
                    raw_transform: Optional[Callable] = None,
                    label_transform: Optional[Callable] = None,
                    transform: Optional[Callable] = None, **loader_kwargs) -> DataLoader:
    """DataLoader for nuclei segmentation / cell-type classification over HEST-1k."""
    ds = get_hest_dataset(path, patch_shape, organs, label_choice, download,
                          n_samples, seed, raw_transform, label_transform, transform)
    return get_data_loader(ds, batch_size, **loader_kwargs)
