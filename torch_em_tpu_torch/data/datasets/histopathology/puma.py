"""PUMA dataset: nucleus and tissue segmentation in melanoma H&E
histopathology (reference torch_em/data/datasets/histopathology/puma.py).

Part of the PUMA Grand Challenge (https://puma.grand-challenge.org/); data at
https://zenodo.org/records/13859989; publication
https://doi.org/10.1093/gigascience/giaf011. The geojson annotations are read
and rasterized by the port's own ``utils/geometry.py``, with no geopandas or
rasterio.
"""

import json
import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils import geometry
from ....utils.io import _h5py, load_image
from .. import util

URL = {
    "data": "https://zenodo.org/records/15050523/files/01_training_dataset_tif_ROIs.zip",
    "annotations": {
        "nuclei": "https://zenodo.org/records/15050523/files/01_training_dataset_geojson_nuclei.zip",
        "tissue": "https://zenodo.org/records/15050523/files/01_training_dataset_geojson_tissue.zip",
    },
}

CHECKSUM = {
    "data": "af48b879f8ff7e74b84a7114924881606f13f108aa0f9bcc21d3593b717ee022",
    "annotations": {
        "nuclei": "eda271225900d6de0759e0281f3731a570e09f2adab58bd36425b9d2dfad91a0",
        "tissue": "fc2835135cc28324f52eac131327f0f12c554c0b1f334a108bf4b65e0f18c42b",
    },
}

NUCLEI_CLASS_DICT = {
    "nuclei_stroma": 1, "nuclei_tumor": 2, "nuclei_plasma_cell": 3,
    "nuclei_histiocyte": 4, "nuclei_lymphocyte": 5, "nuclei_melanophage": 6,
    "nuclei_neutrophil": 7, "nuclei_endothelium": 8, "nuclei_epithelium": 9,
    "nuclei_apoptosis": 10,
}

TISSUE_CLASS_DICT = {
    "tissue_stroma": 1, "tissue_tumor": 2, "tissue_epidermis": 3,
    "tissue_blood_vessel": 4, "tissue_necrosis": 5, "tissue_white_background": 6,
}

CLASS_DICT = {"nuclei": NUCLEI_CLASS_DICT, "tissue": TISSUE_CLASS_DICT}


def _split_sample_ids(ids, rng):
    """80/20 test split, then 15% of train for val (reference puma.py:95-99)."""
    ids = list(ids)
    rng.shuffle(ids)
    n_test = int(round(0.2 * len(ids)))
    test, train = ids[:n_test], ids[n_test:]
    n_val = int(round(0.15 * len(train)))
    val, train = train[:n_val], train[n_val:]
    return train, val, test


def _create_split_csv(path, annotations, split):
    import pandas as pd

    csv_path = os.path.join(path, "puma_split.csv")
    if os.path.exists(csv_path):
        df = pd.read_csv(csv_path)
        df[split] = df[split].apply(lambda x: json.loads(x.replace("'", '"')))
        return df.iloc[0][split]

    roi_dir = os.path.join(path, "data", "01_training_dataset_tif_ROIs")
    metastatic_ids = [os.path.basename(p).split(".")[0]
                      for p in glob(os.path.join(roi_dir, "*metastatic*"))]
    primary_ids = [os.path.basename(p).split(".")[0]
                   for p in glob(os.path.join(roi_dir, "*primary*"))]

    rng = np.random.RandomState()
    train_ids, val_ids, test_ids = _split_sample_ids(metastatic_ids, rng)
    ptrain, pval, ptest = _split_sample_ids(primary_ids, rng)
    split_ids = {"train": train_ids + ptrain, "val": val_ids + pval, "test": test_ids + ptest}
    pd.DataFrame.from_dict([split_ids]).to_csv(csv_path, index=False)
    return split_ids[split]


def _classification(entry):
    """A feature's ``classification``: a dict in raw GeoJSON, a JSON string where geopandas read the file."""
    return json.loads(entry) if isinstance(entry, str) else entry


def _preprocess_inputs(path, annotations, split):
    h5py = _h5py()

    annotation_paths = glob(os.path.join(
        path, "annotations", annotations, f"01_training_dataset_geojson_{annotations}", "*.geojson"))
    roi_dir = os.path.join(path, "data", "01_training_dataset_tif_ROIs")
    preprocessed_dir = os.path.join(path, split, "preprocessed")
    os.makedirs(preprocessed_dir, exist_ok=True)

    split_list = _create_split_csv(path, annotations, split)

    for ann_path in annotation_paths:
        fname = os.path.basename(ann_path).replace(f"_{annotations}.geojson", ".tif")
        image_path = os.path.join(roi_dir, fname)
        if not os.path.exists(image_path):
            image_path = image_path + "f"  # sample 103 uses .tiff
        if os.path.basename(image_path).split(".")[0] not in split_list:
            continue
        assert os.path.exists(image_path), image_path

        volume_path = os.path.join(preprocessed_dir, str(Path(fname).with_suffix(".h5")))
        gdf = geometry.read_geojson(ann_path)
        minx, miny, maxx, maxy = gdf.total_bounds
        width, height = 1024, 1024  # roi shape
        transform = geometry.from_bounds(minx, miny, maxx, maxy, width, height)

        class_dict = CLASS_DICT[annotations]
        class_ids = [class_dict[_classification(cls_entry)["name"]] for cls_entry in gdf["classification"]]
        semantic_mask = geometry.rasterize(
            ((geom, cid) for geom, cid in zip(gdf.geometry, class_ids)),
            out_shape=(height, width), transform=transform, fill=0, dtype=np.uint8)

        gdf["id"] = range(1, len(gdf) + 1)
        instance_mask = geometry.rasterize(
            ((geom, uid) for geom, uid in zip(gdf.geometry, gdf["id"])),
            out_shape=(height, width), transform=transform, fill=0, dtype=np.int32)

        # match the expected orientation
        instance_mask = np.fliplr(np.flip(instance_mask))
        semantic_mask = np.fliplr(np.flip(semantic_mask))

        image = np.asarray(load_image(image_path))
        image = image[..., :-1].transpose(2, 0, 1)

        with h5py.File(volume_path, "a") as f:
            if "raw" not in f.keys():
                f.create_dataset("raw", data=image, compression="gzip")
            if f"labels/instances/{annotations}" not in f.keys():
                f.create_dataset(f"labels/instances/{annotations}", data=instance_mask, compression="gzip")
            if f"labels/semantic/{annotations}" not in f.keys():
                f.create_dataset(f"labels/semantic/{annotations}", data=semantic_mask, compression="gzip")


def _annotations_are_stored(data_dir, annotations):
    h5py = _h5py()

    volume_paths = glob(os.path.join(data_dir, "preprocessed", "*.h5"))
    if not volume_paths:
        return False
    with h5py.File(volume_paths[0], "r") as f:
        return f"labels/instances/{annotations}" in f.keys()


def get_puma_data(path: Union[os.PathLike, str], split: str,
                  annotations: str = "nuclei", download: bool = False) -> str:
    """Download and preprocess the PUMA data for a split + annotation type."""
    if annotations not in ("nuclei", "tissue"):
        raise ValueError(f"'{annotations}' is not a valid annotation for the data.")

    data_dir = os.path.join(str(path), split)
    if os.path.exists(data_dir) and _annotations_are_stored(data_dir, annotations):
        return data_dir

    os.makedirs(str(path), exist_ok=True)
    if not os.path.exists(os.path.join(str(path), "data")):
        zip_path = os.path.join(str(path), "roi.zip")
        util.download_source(path=zip_path, url=URL["data"], download=download, checksum=CHECKSUM["data"])
        util.unzip(zip_path=zip_path, dst=os.path.join(str(path), "data"))

    zip_path = os.path.join(str(path), "annotations.zip")
    util.download_source(path=zip_path, url=URL["annotations"][annotations],
                         download=download, checksum=CHECKSUM["annotations"][annotations])
    util.unzip(zip_path=zip_path, dst=os.path.join(str(path), "annotations", annotations))

    _preprocess_inputs(str(path), annotations, split)
    return data_dir


def get_puma_paths(path: Union[os.PathLike, str], split: str,
                   annotations: str = "nuclei", download: bool = False) -> List[str]:
    """Paths to the preprocessed PUMA h5 volumes."""
    data_dir = get_puma_data(path, split, annotations, download)
    return util.natsorted(glob(os.path.join(data_dir, "preprocessed", "*.h5")))


def get_puma_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                     split: str, annotations: str = "nuclei",
                     label_choice: str = "instances", resize_inputs: bool = False,
                     download: bool = False, **kwargs):
    """Dataset for nuclei/tissue segmentation in melanoma H&E."""
    volume_paths = get_puma_paths(path, split, annotations, download)
    if resize_inputs:
        resize_kwargs = {"patch_shape": patch_shape, "is_rgb": True}
        kwargs, patch_shape = util.update_kwargs_for_resize_trafo(
            kwargs=kwargs, patch_shape=patch_shape, resize_inputs=resize_inputs,
            resize_kwargs=resize_kwargs)
    return default_segmentation_dataset(
        raw_paths=volume_paths, raw_key="raw",
        label_paths=volume_paths, label_key=f"labels/{label_choice}/{annotations}",
        patch_shape=patch_shape, with_channels=True, is_seg_dataset=True, ndim=2, **kwargs,
    )


def get_puma_loader(path: Union[os.PathLike, str], batch_size: int,
                    patch_shape: Tuple[int, int], split: str,
                    annotations: str = "nuclei", label_choice: str = "instances",
                    resize_inputs: bool = False, download: bool = False,
                    **kwargs) -> DataLoader:
    """DataLoader for nuclei/tissue segmentation in melanoma H&E."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_puma_dataset(path, patch_shape, split, annotations, label_choice,
                          resize_inputs, download, **ds_kwargs)
    return get_data_loader(ds, batch_size, **loader_kwargs)
