"""EMNeuron dataset: neuron segmentation corpus across EM modalities
(reference torch_em/data/datasets/electron_microscopy/emneuron.py).

The data must be downloaded manually from
https://huggingface.co/datasets/yanchaoz/EMNeuron (labeled.rar / valid.rar);
see https://github.com/yanchaoz/SegNeuron.
"""

import os
from glob import glob
from typing import List, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util


def get_emneuron_data(path: Union[os.PathLike, str], split: str, download: bool = False):
    """Unpack the manually downloaded EMNeuron rar archives."""
    if download:
        raise NotImplementedError(
            "Automatic download is not supported for EMNeuron; download 'labeled.rar' and "
            "'valid.rar' from https://huggingface.co/datasets/yanchaoz/EMNeuron."
        )
    os.makedirs(path, exist_ok=True)
    if split == "train":
        rar_path = os.path.join(path, "labeled.rar")
    elif split == "val":
        rar_path = os.path.join(path, "valid.rar")
    else:
        raise ValueError(f"'{split}' is not a valid split; choose 'train' or 'val'.")
    if os.path.exists(os.path.splitext(rar_path)[0]):
        return
    util.unzip_rarfile(rar_path, path, remove=False, use_rarfile=False)


def get_emneuron_paths(path: Union[os.PathLike, str], split: str,
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the EMNeuron volumes."""
    get_emneuron_data(path, split, download)
    if split == "train":
        label_paths = util.natsorted(glob(os.path.join(path, "labeled", "*", "*_MaskIns.tif")))
        raw_paths = [os.path.join(os.path.dirname(p),
                                  os.path.basename(p).replace("_MaskIns", ""))
                     for p in label_paths]
    else:
        raw_paths = util.natsorted(glob(os.path.join(path, "valid", "*", "*", "raw.tif")))
        label_paths = [
            os.path.join(os.path.dirname(p), "label_0.tif")
            if os.path.exists(os.path.join(os.path.dirname(p), "label_0.tif"))
            else os.path.join(os.path.dirname(p), "label.tif")
            for p in raw_paths
        ]
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_emneuron_dataset(path: Union[os.PathLike, str], patch_shape, split: str,
                         download: bool = False, **kwargs):
    """Get the EMNeuron dataset for neuron segmentation."""
    raw_paths, label_paths = get_emneuron_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape, **kwargs)


def get_emneuron_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                        split: str, download: bool = False, **kwargs) -> DataLoader:
    """Get the EMNeuron data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_emneuron_dataset(path, patch_shape, split, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
