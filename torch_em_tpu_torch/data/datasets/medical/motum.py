"""MOTUM dataset: multi-origin brain tumor segmentation in FLAIR / T1CE MRI
(reference torch_em/data/datasets/medical/motum.py).

Located at https://doi.gin.g-node.org/10.12751/g-node.tvzqc5/;
publication: https://doi.org/10.1038/s41597-024-03634-0
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://doi.gin.g-node.org/10.12751/g-node.tvzqc5/10.12751_g-node.tvzqc5.zip"
CHECKSUM = "2626862599a3fcfe4ac0cefcea3af5b190625275036cc8eb4c9039cbd54e2d7c"


def get_motum_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download the MOTUM data."""
    if os.path.exists(os.path.join(path, "derivatives")):
        return path
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "data.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return path


def get_motum_paths(path: Union[os.PathLike, str], split: str, modality: str = "flair",
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the MOTUM volumes (modality 'flair' or 't1ce';
    35/10/rest split)."""
    if modality not in ("flair", "t1ce"):
        raise ValueError(f"'{modality}' is not a valid modality.")
    data_dir = get_motum_data(path, download)
    raw_paths = util.natsorted(
        glob(os.path.join(data_dir, "sub-*", "anat", f"sub-*_{modality}.nii.gz")))
    label_paths = util.natsorted(
        glob(os.path.join(data_dir, "derivatives", "sub-*", f"{modality}_seg_*.nii.gz")))
    # labels without preprocessed volumes
    missing_inputs = ["sub-0030", "sub-0031", "sub-0032"]
    label_paths = [p for p in label_paths if all(p.find(f) == -1 for f in missing_inputs)]
    if split == "train":
        raw_paths, label_paths = raw_paths[:35], label_paths[:35]
    elif split == "val":
        raw_paths, label_paths = raw_paths[35:45], label_paths[35:45]
    elif split == "test":
        raw_paths, label_paths = raw_paths[45:], label_paths[45:]
    else:
        raise ValueError(f"'{split}' is not a valid split.")
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_motum_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                      split: str, modality: str = "flair", download: bool = False,
                      **kwargs):
    """Get the MOTUM dataset for brain tumor segmentation."""
    raw_paths, label_paths = get_motum_paths(path, split, modality, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_motum_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                     batch_size: int, split: str, modality: str = "flair",
                     download: bool = False, **kwargs) -> DataLoader:
    """Get the MOTUM data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_motum_dataset(path, patch_shape, split, modality=modality,
                           download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
