"""HPA dataset: cell segmentation in Human Protein Atlas 4-channel images
(reference torch_em/data/datasets/light_microscopy/hpa.py).

Publication: https://doi.org/10.1038/s41592-019-0658-6

The kaibu-style JSON polygon annotations are rasterized with PIL polygon
fill per feature (the reference additionally erodes edges and removes
sub-500px objects; instance identity and shape are preserved here).
"""

import json
import os
from concurrent import futures
from functools import partial
from glob import glob
from typing import List, Sequence, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, _pil_draw, _pil_image, load_image
from .. import util

URLS = {"segmentation": "https://zenodo.org/record/4665863/files/hpa_dataset_v2.zip"}
CHECKSUMS = {"segmentation": "dcd6072293d88d49c71376d3d99f3f4f102e4ee83efb0187faa89c95ec49faa9"}
VALID_CHANNELS = ["microtubules", "protein", "nuclei", "er"]


def _get_labels(annotation_file, shape):
    Image, ImageDraw = _pil_image(), _pil_draw()

    with open(annotation_file) as f:
        features = json.load(f)["features"]
    labels = Image.new("I", (shape[1], shape[0]), 0)
    draw = ImageDraw.Draw(labels)
    instance_id = 1
    for feature in features:
        geom = feature.get("geometry", {})
        coords = geom.get("coordinates", [])
        if geom.get("type") == "Polygon":
            rings = coords
        elif geom.get("type") == "MultiPolygon":
            rings = [r for poly in coords for r in poly]
        else:
            continue
        for ring in rings[:1]:  # outer ring only
            pts = [(float(x), float(shape[0] - y)) for x, y in ring]
            if len(pts) >= 3:
                draw.polygon(pts, outline=instance_id, fill=instance_id)
        instance_id += 1
    return np.asarray(labels, dtype="uint16")


def _process_image(in_folder, out_path, with_labels):
    h5py = _h5py()

    raw = np.concatenate([
        np.asarray(load_image(os.path.join(in_folder, f"{chan}.png")))[None]
        for chan in VALID_CHANNELS
    ], axis=0)
    labels = None
    if with_labels:
        annotation_file = os.path.join(in_folder, "annotation.json")
        assert os.path.exists(annotation_file), annotation_file
        labels = _get_labels(annotation_file, raw.shape[1:])
    with h5py.File(out_path, "w") as f:
        for i, chan in enumerate(VALID_CHANNELS):
            f.create_dataset(f"raw/{chan}", data=raw[i], compression="gzip")
        if labels is not None:
            f.create_dataset("labels", data=labels, compression="gzip")


def _process_split(root_in, root_out, n_workers, with_labels):
    os.makedirs(root_out, exist_ok=True)
    inputs = glob(os.path.join(root_in, "*"))
    outputs = [os.path.join(root_out, f"{os.path.split(inp)[1]}.h5") for inp in inputs]
    process = partial(_process_image, with_labels=with_labels)
    with futures.ThreadPoolExecutor(n_workers) as pool:
        list(pool.map(process, inputs, outputs))


def get_hpa_segmentation_data(path: Union[os.PathLike, str], download: bool = False,
                              n_workers_preproc: int = 8) -> str:
    """Download and preprocess the HPA segmentation data."""
    have_all = all(
        glob(os.path.join(path, split, "*.h5")) for split in ("train", "val", "test")
    ) if os.path.exists(path) else False
    if have_all:
        return path
    os.makedirs(path, exist_ok=True)
    in_path = os.path.join(path, "hpa_dataset_v2")
    if not os.path.exists(in_path):
        zip_path = os.path.join(path, "hpa_dataset_v2.zip")
        util.download_source(zip_path, URLS["segmentation"], download, CHECKSUMS["segmentation"])
        util.unzip(zip_path, path, remove=False)
    for split in ("train", "test", "valid"):
        out_split = "val" if split == "valid" else split
        _process_split(os.path.join(in_path, split), os.path.join(path, out_split),
                       n_workers=n_workers_preproc, with_labels=(split != "test"))
    return path


def get_hpa_segmentation_paths(path: Union[os.PathLike, str], split: str,
                               download: bool = False,
                               n_workers_preproc: int = 8) -> List[str]:
    """Get paths to the HPA volumes for a split."""
    get_hpa_segmentation_data(path, download, n_workers_preproc)
    return util.natsorted(glob(os.path.join(path, split, "*.h5")))


def get_hpa_segmentation_dataset(path: Union[os.PathLike, str], split: str, patch_shape,
                                 offsets=None, boundaries: bool = False, binary: bool = False,
                                 channels: Sequence[str] = VALID_CHANNELS,
                                 download: bool = False, n_workers_preproc: int = 8, **kwargs):
    """Get the HPA dataset for cell segmentation."""
    paths = get_hpa_segmentation_paths(path, split, download, n_workers_preproc)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries, offsets=offsets,
    )
    raw_key = [f"raw/{chan}" for chan in channels]
    return default_segmentation_dataset(paths, raw_key, paths, "labels", patch_shape,
                                        ndim=2, with_channels=True, **kwargs)


def get_hpa_segmentation_loader(path: Union[os.PathLike, str], split: str, patch_shape,
                                batch_size: int, offsets=None, boundaries: bool = False,
                                binary: bool = False,
                                channels: Sequence[str] = VALID_CHANNELS,
                                download: bool = False, n_workers_preproc: int = 8,
                                **kwargs) -> DataLoader:
    """Get the HPA data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_hpa_segmentation_dataset(
        path, split, patch_shape, offsets=offsets, boundaries=boundaries, binary=binary,
        channels=channels, download=download, n_workers_preproc=n_workers_preproc, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
