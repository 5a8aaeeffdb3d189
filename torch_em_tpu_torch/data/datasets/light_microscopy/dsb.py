"""DSB 2018 nucleus segmentation dataset (reference
torch_em/data/datasets/light_microscopy/dsb.py).

The 'reduced' dataset is the StarDist fluorescence image set.
Publication: https://doi.org/10.1038/s41592-019-0612-7
"""

import os
import shutil
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image
from .. import util

DSB_URLS = {
    "full": "https://github.com/ibmua/data-science-bowl-2018-train-set/raw/master/train-hand.zip",
    "reduced": "https://github.com/stardist/stardist/releases/download/0.1.0/dsb2018.zip",
}
CHECKSUMS = {
    "full": "d218b8706cd7b9a2d7171268a6e99c7b0e94605af46521ff2ffd5a17708b1af6",
    "reduced": "e44921950edce378063aa4457e625581ba35b4c2dbd9a07c19d48900129f386f",
}


def _merge_instances(path):
    """Preprocess the 'full' source: strip alpha channels, split fluo vs
    histopatho images, and merge per-object masks into one instance map
    (reference dsb.py:41-76)."""
    import numpy as np
    Image = _pil_image()

    for id_path in glob(os.path.join(path, "full", "*")):
        id_ = os.path.basename(id_path)

        image = np.asarray(Image.open(os.path.join(id_path, "images", f"{id_}.png")))
        assert image.ndim == 3 and image.shape[-1] == 4, image.shape
        image = image[..., :-1]  # remove alpha channel
        r, g, b = image.transpose(2, 0, 1)
        if np.array_equal(r, g) and np.array_equal(g, b):
            dname = "fluo"
            # store only one channel for fluorescence images
            Image.fromarray(image[..., -1]).save(os.path.join(id_path, "images", f"{dname}_{id_}.png"))
        else:
            dname = "histopatho"
            Image.fromarray(image).save(os.path.join(id_path, "images", f"{dname}_{id_}.png"))
        os.remove(os.path.join(id_path, "images", f"{id_}.png"))

        # merge the per-object masks into a single instance map
        label_paths = glob(os.path.join(id_path, "masks", "*"))
        shape = np.asarray(Image.open(label_paths[0])).shape
        instances = np.zeros(shape, dtype="int32")  # PIL mode "I" (32-bit int)
        for i, lpath in enumerate(label_paths, start=1):
            instances[np.asarray(Image.open(lpath)) > 0] = i

        os.makedirs(os.path.join(id_path, "preprocessed_labels"), exist_ok=True)
        Image.fromarray(instances).save(
            os.path.join(id_path, "preprocessed_labels", f"{dname}_{id_}.tif"))
        shutil.rmtree(os.path.join(id_path, "masks"))


def get_dsb_data(path: Union[os.PathLike, str], source: str = "reduced",
                 download: bool = False) -> None:
    """Download the DSB training data ('reduced' = StarDist fluorescence set,
    'full' = complete train-hand set incl. histopathology)."""
    if source not in DSB_URLS:
        raise ValueError(f"'{source}' is not a valid data source.")
    train_out_path = os.path.join(path, "train")
    test_out_path = os.path.join(path, "test")
    if source == "reduced" and os.path.exists(train_out_path) and os.path.exists(test_out_path):
        return
    full_out_path = os.path.join(path, "full")
    if source == "full" and os.path.exists(full_out_path):
        return
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "dsb.zip" if source == "reduced" else "train-hand.zip")
    util.download_source(zip_path, DSB_URLS[source], download, CHECKSUMS[source])
    util.unzip(zip_path, path, True)
    if source == "reduced":
        shutil.move(os.path.join(path, "dsb2018", "train"), train_out_path)
        shutil.move(os.path.join(path, "dsb2018", "test"), test_out_path)
    else:
        shutil.move(os.path.join(path, "train-hand"), full_out_path)
        _merge_instances(path)


def get_dsb_paths(path: Union[os.PathLike, str], source: str = "reduced",
                  split: Optional[str] = None, domain: Optional[str] = None,
                  download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the DSB images and labels. For 'full', ``domain`` selects
    'fluo' or 'histopatho' images; 'reduced' has train/test splits."""
    get_dsb_data(path, source, download)
    if source == "reduced":
        if domain is not None:
            assert domain in "fluo", "The reduced set only has 'fluo' images."
        if split is None:
            split = "t*"  # all of train + test
        raw_paths = util.natsorted(glob(os.path.join(path, split, "images", "*.tif")))
        label_paths = util.natsorted(glob(os.path.join(path, split, "masks", "*.tif")))
    else:
        if domain is None:
            domain = "*"
        assert split is None, "There are no splits available for this data."
        raw_paths = util.natsorted(glob(os.path.join(path, "full", "*", "images", f"{domain}_*.png")))
        label_paths = util.natsorted(
            glob(os.path.join(path, "full", "*", "preprocessed_labels", f"{domain}_*.tif")))
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_dsb_dataset(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int],
    split: Optional[str] = None,
    source: str = "reduced",
    domain: Optional[str] = None,
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    **kwargs,
):
    """Get the DSB dataset for nucleus segmentation."""
    if split is not None:
        assert split in ("train", "test")
    raw_paths, label_paths = get_dsb_paths(path, source, split, domain, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, label_dtype = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries, offsets=offsets,
    )
    if label_dtype is not None:
        kwargs["label_dtype"] = label_dtype
    return default_segmentation_dataset(
        raw_paths, None, label_paths, None, patch_shape, is_seg_dataset=False, ndim=2, **kwargs,
    )


def get_dsb_loader(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int],
    batch_size: int,
    split: Optional[str] = None,
    source: str = "reduced",
    domain: Optional[str] = None,
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    **kwargs,
) -> DataLoader:
    """Get the DSB data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_dsb_dataset(
        path, patch_shape, split=split, source=source, domain=domain, download=download,
        offsets=offsets, boundaries=boundaries, binary=binary, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
