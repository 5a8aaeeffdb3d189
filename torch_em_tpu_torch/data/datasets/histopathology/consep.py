"""CoNSeP dataset: nucleus segmentation in colorectal H&E
(reference torch_em/data/datasets/histopathology/consep.py).

Located at https://www.kaggle.com/datasets/rftexas/tiled-consep-224x224px;
publication: https://doi.org/10.1016/j.media.2019.101563

The published data ships as 224x224 tiles; they are stitched back into
whole images here, merging instances that touch across tile seams.
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, load_image
from .. import util


def _merge_seam_instances(labels, tile_shape):
    """Union instance ids that touch across tile boundaries (simple
    union-find replacement for elf's stitch_tiled_segmentation)."""
    parent = {}

    def find(a):
        while parent.get(a, a) != a:
            parent[a] = parent.get(parent[a], parent[a])
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    h, w = labels.shape
    for y in range(tile_shape[0], h, tile_shape[0]):
        top, bottom = labels[y - 1], labels[y]
        both = (top > 0) & (bottom > 0)
        for a, b in zip(top[both], bottom[both]):
            union(int(a), int(b))
    for x in range(tile_shape[1], w, tile_shape[1]):
        left, right = labels[:, x - 1], labels[:, x]
        both = (left > 0) & (right > 0)
        for a, b in zip(left[both], right[both]):
            union(int(a), int(b))

    out = labels.copy()
    ids = np.unique(labels)
    mapping = {int(i): find(int(i)) for i in ids if i != 0}
    # relabel consecutively
    roots = sorted(set(mapping.values()))
    root_to_new = {r: i + 1 for i, r in enumerate(roots)}
    lut = np.zeros(int(labels.max()) + 1, dtype="uint32")
    for i, r in mapping.items():
        lut[i] = root_to_new[r]
    return lut[out]


def _preprocess_image(raw_paths, label_paths, output_path):
    h5py = _h5py()
    from scipy.io import loadmat

    from ....ops.host import connected_components

    tile_coordinates = [
        tuple(int(c) for c in Path(p).stem.split("_")[2:]) for p in raw_paths
    ]
    h = max(c[1] for c in tile_coordinates)
    w = max(c[3] for c in tile_coordinates)

    raw = np.zeros((h, w, 3), dtype="uint8")
    for path, (y1, y2, x1, x2) in zip(raw_paths, tile_coordinates):
        raw[y1:y2, x1:x2] = np.asarray(load_image(path))[..., :3]

    offset = 0
    labels = np.zeros((h, w), dtype="uint32")
    written = np.zeros((h, w), dtype=bool)
    for path, (y1, y2, x1, x2) in zip(label_paths, tile_coordinates):
        tile_labels = connected_components(loadmat(path)["instance_map"]).astype("uint32")
        tile_mask = (tile_labels != 0) & ~written[y1:y2, x1:x2]
        if tile_mask.sum() > 0:
            tile_labels[tile_mask] += offset
            offset = int(tile_labels.max())
        written[y1:y2, x1:x2][tile_mask] = 1
        labels[y1:y2, x1:x2][tile_mask] = tile_labels[tile_mask]

    stitched = _merge_seam_instances(labels, tile_shape=(224, 224))
    with h5py.File(output_path, "w") as f:
        f.create_dataset("raw", data=raw.transpose(2, 0, 1), compression="gzip")
        f.create_dataset("labels", data=stitched, compression="gzip")


def _preprocess_data(data_dir, split):
    preprocessed_dir = os.path.join(data_dir, "preprocessed", split)
    os.makedirs(preprocessed_dir, exist_ok=True)
    n_images = 28 if split == "train" else 15
    for image_id in range(1, n_images):
        output_path = os.path.join(preprocessed_dir, f"{image_id}.h5")
        if os.path.exists(output_path):
            continue
        raw_paths = util.natsorted(
            glob(os.path.join(data_dir, "tiles", f"{split}_{image_id}_*.png")))
        if not raw_paths:
            continue
        label_paths = [p.replace("tiles", "labels").replace(".png", ".mat") for p in raw_paths]
        _preprocess_image(raw_paths, label_paths, output_path)


def get_consep_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the CoNSeP data (kaggle)."""
    data_dir = os.path.join(path, "data", "consep")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    util.download_source_kaggle(path, "rftexas/tiled-consep-224x224px", download)
    util.unzip(os.path.join(path, "tiled-consep-224x224px.zip"), os.path.join(path, "data"))
    return data_dir


def get_consep_paths(path: Union[os.PathLike, str], split: str,
                     download: bool = False) -> List[str]:
    """Get paths to the CoNSeP volumes for a split ('train' / 'test')."""
    if split not in ("train", "test"):
        raise ValueError(f"'{split}' is not a valid split.")
    data_dir = get_consep_data(path, download)
    _preprocess_data(data_dir, split)
    return util.natsorted(glob(os.path.join(data_dir, "preprocessed", split, "*.h5")))


def get_consep_dataset(path: Union[os.PathLike, str], patch_shape, split: str,
                       download: bool = False, **kwargs):
    """Get the CoNSeP dataset for nucleus segmentation."""
    paths = get_consep_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(paths, "raw", paths, "labels", patch_shape,
                                        ndim=2, with_channels=True, **kwargs)


def get_consep_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                      split: str, download: bool = False, **kwargs) -> DataLoader:
    """Get the CoNSeP data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_consep_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
