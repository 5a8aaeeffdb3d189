"""CREMI neuron segmentation challenge data (reference
torch_em/data/datasets/electron_microscopy/cremi.py).

EM volumes A/B/C with neuron segmentation; supports boundary/affinity targets
and the EM defect augmentation (https://cremi.org).
"""

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ... import ConcatDataset, DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

CREMI_URLS = {
    "original": {
        "A": "https://cremi.org/static/data/sample_A_20160501.hdf",
        "B": "https://cremi.org/static/data/sample_B_20160501.hdf",
        "C": "https://cremi.org/static/data/sample_C_20160501.hdf",
    },
    "realigned": {},
    "defects": "https://zenodo.org/record/5767036/files/sample_ABC_padded_defects.h5",
}
CHECKSUMS = {
    "original": {
        "A": "4c563d1b78acb2bcfb3ea958b6fe1533422f7f4a19f3e05b600bfa11430b510d",
        "B": "887e85521e00deead18c94a21ad71f278d88a5214c7edeed943130a1f4bb48b8",
        "C": "2874496f224d222ebc29d0e4753e8c458093e1d37bc53acd1b69b19ed1ae7052",
    },
    "realigned": {},
    "defects": "7b06ffa34733b2c32956ea5005e0cf345e7d3a27477f42f7c905701cdc947bd0",
}


def get_cremi_data(path: Union[os.PathLike, str], samples: Tuple[str, ...] = ("A", "B", "C"),
                   use_realigned: bool = False, download: bool = False) -> None:
    """Download the CREMI training data."""
    if use_realigned:
        raise NotImplementedError("The realigned CREMI data is not available for download.")
    urls, checksums = CREMI_URLS["original"], CHECKSUMS["original"]
    os.makedirs(path, exist_ok=True)
    for sample in samples:
        data_path = os.path.join(path, f"sample_{sample}.h5")
        util.download_source(data_path, urls[sample], download, checksum=checksums[sample])


def get_cremi_paths(path: Union[os.PathLike, str], samples: Tuple[str, ...] = ("A", "B", "C"),
                    use_realigned: bool = False, download: bool = False) -> List[str]:
    """Get paths to the CREMI data."""
    get_cremi_data(path, samples, use_realigned, download)
    data_paths = [os.path.join(path, f"sample_{sample}.h5") for sample in samples]
    for data_path in data_paths:
        assert os.path.exists(data_path), data_path
    return data_paths


def get_cremi_dataset(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int, int],
    samples: Tuple[str, ...] = ("A", "B", "C"),
    use_realigned: bool = False,
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    rois: Optional[Dict[str, Any]] = {},
    defect_augmentation_kwargs: Optional[Dict[str, Any]] = {
        "p_drop_slice": 0.025, "p_low_contrast": 0.025, "p_deform_slice": 0.0,
        "deformation_mode": "compress",
    },
    **kwargs,
):
    """Get the CREMI dataset for neuron segmentation."""
    assert len(patch_shape) == 3
    if rois is not None and len(rois) > 0:
        assert isinstance(rois, dict)
        per_sample_rois = tuple(rois.get(sample, np.s_[:, :, :]) for sample in samples)
    else:
        per_sample_rois = None

    if defect_augmentation_kwargs is not None and "raw_transform" not in kwargs:
        from ....transforms.defect import EMDefectAugmentation
        from ....transforms.raw import get_raw_transform

        raw_transform = get_raw_transform(
            augmentation2=EMDefectAugmentation(**defect_augmentation_kwargs)
        )
        kwargs = util.update_kwargs(kwargs, "raw_transform", raw_transform)

    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=False, boundaries=boundaries, offsets=offsets,
    )

    data_paths = get_cremi_paths(path, samples, use_realigned, download)
    raw_key = "volumes/raw"
    label_key = "volumes/labels/neuron_ids"
    return default_segmentation_dataset(
        data_paths, raw_key, data_paths, label_key, patch_shape,
        rois=per_sample_rois, **kwargs,
    )


def get_cremi_loader(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int, int],
    batch_size: int,
    samples: Tuple[str, ...] = ("A", "B", "C"),
    use_realigned: bool = False,
    download: bool = False,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    rois: Optional[Dict[str, Any]] = {},
    defect_augmentation_kwargs: Optional[Dict[str, Any]] = {
        "p_drop_slice": 0.025, "p_low_contrast": 0.025, "p_deform_slice": 0.0,
        "deformation_mode": "compress",
    },
    **kwargs,
) -> DataLoader:
    """Get the CREMI data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    dataset = get_cremi_dataset(
        path=path, patch_shape=patch_shape, samples=samples, use_realigned=use_realigned,
        download=download, offsets=offsets, boundaries=boundaries, rois=rois,
        defect_augmentation_kwargs=defect_augmentation_kwargs, **ds_kwargs,
    )
    return get_data_loader(dataset, batch_size=batch_size, **loader_kwargs)
