"""BTCV dataset: abdominal and cervical multi-organ segmentation in CT
(reference torch_em/data/datasets/medical/btcv.py).

The data must be downloaded manually from the synapse challenge
(https://www.synapse.org/#!Synapse:syn3193805/wiki/89480), providing the
'Abdomen' and/or 'Cervix' RawData zips at ``path``.
"""

import os
from glob import glob
from typing import List, Optional, Sequence, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

ABDOMEN_ORGANS = {
    "spleen": 1, "right kidney": 2, "left kidney": 3, "gallbladder": 4, "esophagus": 5,
    "liver": 6, "stomach": 7, "aorta": 8, "inferior vena cava": 9,
    "portal vein and splenic vein": 10, "pancreas": 11, "right adrenal gland": 12,
    "left adrenal gland": 13,
}
CERVICAL_ORGANS = {"bladder": 1, "uterus": 2, "rectum": 3, "small bowel": 4}
ANATOMIES = ("Abdomen", "Cervix")


def get_btcv_data(path: Union[os.PathLike, str], anatomy: Sequence[str],
                  download: bool = False):
    """Unpack the manually downloaded BTCV zips for the chosen anatomies."""
    if download:
        raise NotImplementedError(
            "BTCV must be downloaded manually via synapse "
            "(https://www.synapse.org/#!Synapse:syn3193805); place the RawData zips at the path."
        )
    for region in anatomy:
        assert region in ANATOMIES, f"Invalid anatomy: {region}"
        region_dir = os.path.join(path, region)
        if os.path.exists(region_dir):
            continue
        zips = glob(os.path.join(path, f"*{region}*.zip")) + \
            glob(os.path.join(path, "RawData.zip"))
        if not zips:
            raise FileNotFoundError(
                f"Could not find the '{region}' zip at {path}; download it from synapse.")
        util.unzip(zips[0], region_dir, remove=False)


def get_btcv_paths(path: Union[os.PathLike, str],
                   anatomy: Optional[Sequence[str]] = None,
                   download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the BTCV training volumes and labels."""
    if anatomy is None:
        anatomy = [a for a in ANATOMIES if os.path.exists(os.path.join(path, a))] or ["Abdomen"]
    elif isinstance(anatomy, str):
        anatomy = [anatomy]
    get_btcv_data(path, anatomy, download)
    raw_paths, label_paths = [], []
    for region in anatomy:
        raw_paths.extend(sorted(glob(
            os.path.join(path, region, "RawData", "Training", "img", "*.nii.gz"))))
        label_paths.extend(sorted(glob(
            os.path.join(path, region, "RawData", "Training", "label", "*.nii.gz"))))
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_btcv_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                     anatomy: Optional[Sequence[str]] = None,
                     download: bool = False, **kwargs):
    """Get the BTCV dataset for multi-organ segmentation."""
    raw_paths, label_paths = get_btcv_paths(path, anatomy, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_btcv_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                    batch_size: int, anatomy: Optional[Sequence[str]] = None,
                    download: bool = False, **kwargs) -> DataLoader:
    """Get the BTCV data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_btcv_dataset(path, patch_shape, anatomy=anatomy, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
