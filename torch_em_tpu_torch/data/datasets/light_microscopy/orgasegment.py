"""OrgaSegment dataset: intestinal organoid segmentation in brightfield
(reference torch_em/data/datasets/light_microscopy/orgasegment.py).

Publication: https://doi.org/10.1038/s42003-024-05966-4
"""

import os
import shutil
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/records/10278229/files/OrganoidBasic_v20211206.zip"
CHECKSUM = "d067124d734108e46e18f65daaf17c89cb0a40bdacc6f6031815a6839e472798"


def get_orgasegment_data(path: Union[os.PathLike, str], split: str,
                         download: bool = False) -> str:
    """Download the OrgaSegment data for a split ('train', 'val' or 'eval')."""
    os.makedirs(path, exist_ok=True)
    data_dir = os.path.join(path, split)
    if os.path.exists(data_dir):
        return data_dir
    zip_path = os.path.join(path, "OrganoidBasic_v20211206.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path, remove=True)
    extracted = os.path.join(path, "OrganoidBasic_v20211206")
    for s in ("train", "val", "eval"):
        shutil.move(os.path.join(extracted, s), os.path.join(path, s))
    shutil.rmtree(extracted)
    return data_dir


def get_orgasegment_paths(path: Union[os.PathLike, str], split: str,
                          download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the OrgaSegment images and organoid masks."""
    data_dir = get_orgasegment_data(path, split, download)
    image_paths = sorted(glob(os.path.join(data_dir, "*_img.jpg")))
    label_paths = sorted(glob(os.path.join(data_dir, "*_masks_organoid.png")))
    assert len(image_paths) == len(label_paths)
    return image_paths, label_paths


def get_orgasegment_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                            split: str, boundaries: bool = False, binary: bool = False,
                            download: bool = False, **kwargs):
    """Get the OrgaSegment dataset for organoid segmentation."""
    assert split in ("train", "val", "eval")
    image_paths, label_paths = get_orgasegment_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries,
    )
    return default_segmentation_dataset(image_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_orgasegment_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                           batch_size: int, split: str, boundaries: bool = False,
                           binary: bool = False, download: bool = False, **kwargs) -> DataLoader:
    """Get the OrgaSegment data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_orgasegment_dataset(path, patch_shape, split, boundaries=boundaries,
                                 binary=binary, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
