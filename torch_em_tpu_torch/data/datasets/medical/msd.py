"""MSD: the Medical Segmentation Decathlon's ten CT/MRI segmentation tasks
(reference torch_em/data/datasets/medical/msd.py).

Hosted at msd-for-monai on S3; publication:
https://doi.org/10.1038/s41467-022-30695-9
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Tuple, Union

from ... import DataLoader
from ...concat_dataset import ConcatDataset
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

_S3 = "https://msd-for-monai.s3-us-west-2.amazonaws.com"
URL = {
    "braintumour": f"{_S3}/Task01_BrainTumour.tar",
    "heart": f"{_S3}/Task02_Heart.tar",
    "liver": f"{_S3}/Task03_Liver.tar",
    "hippocampus": f"{_S3}/Task04_Hippocampus.tar",
    "prostate": f"{_S3}/Task05_Prostate.tar",
    "lung": f"{_S3}/Task06_Lung.tar",
    "pancreas": f"{_S3}/Task07_Pancreas.tar",
    "hepaticvessel": f"{_S3}/Task08_HepaticVessel.tar",
    "spleen": f"{_S3}/Task09_Spleen.tar",
    "colon": f"{_S3}/Task10_Colon.tar",
}
CHECKSUM = {
    "braintumour": "d423911308d2ae5396d9c6bf4fad2b68cfde2dd09044269da9c0d639c22753c4",
    "heart": "4277dc6dfe100142aa8060e895f6ff0f81c5b733703ea250bd294df8f820bcba",
    "liver": "4007d9db1acda850d57a6ceb2b3998b7a0d43f8ad5a3f740dc38bc0cb8b7a2c5",
    "hippocampus": "282d808a3e84e5a52f090d9dd4c0b0057b94a6bd51ad41569aef5ff303287771",
    "prostate": "8cbbd7147691109b880ff8774eb6ab26704b1be0935482e7996a36a4ed31ec79",
    "lung": "f782cd09da9cf7a3128475d4a53650d371db10f0427aa76e166fccfcb2654161",
    "pancreas": "e40181a0229ca85c2588d6ebb90fa6674f84eb1e66f0f968cda088d011769732",
    "hepaticvessel": "ee880799f12e3b6e1ef2f8645f6626c5b39de77a4f1eae6f496c25fbf306ba04",
    "spleen": "dfeba347daae4fb08c38f4d243ab606b28b91b206ffc445ec55c35489fa65e60",
    "colon": "a26bfd23faf2de703f5a51a262cd4e2b9774c47e7fb86f0e0a854f8446ec2325",
}
FILENAMES = {task: url.rsplit("/", 1)[-1] for task, url in URL.items()}


def get_msd_data(path: Union[os.PathLike, str], task_name: str,
                 download: bool = False) -> str:
    """Download one MSD task."""
    assert task_name in URL, f"Invalid task: {task_name}; choose from {sorted(URL)}."
    data_dir = os.path.join(path, "data", task_name)
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    fpath = os.path.join(path, FILENAMES[task_name])
    util.download_source(fpath, URL[task_name], download, checksum=None)
    util.unzip_tarfile(fpath, data_dir, remove=False)
    return data_dir


def get_msd_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                    task_names: Union[str, List[str]], download: bool = False, **kwargs):
    """Get the MSD dataset(s) for one or several tasks (braintumour and
    prostate are multi-channel)."""
    if isinstance(task_names, str):
        task_names = [task_names]
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    datasets = []
    for task_name in task_names:
        data_dir = get_msd_data(path, task_name, download)
        task_root = os.path.join(data_dir, Path(FILENAMES[task_name]).stem)
        image_paths = sorted(glob(os.path.join(task_root, "imagesTr", "*.nii.gz")))
        label_paths = sorted(glob(os.path.join(task_root, "labelsTr", "*.nii.gz")))
        task_kwargs = dict(kwargs)
        if task_name in ("braintumour", "prostate"):
            task_kwargs["with_channels"] = True
        datasets.append(default_segmentation_dataset(
            image_paths, None, label_paths, None, patch_shape, **task_kwargs))
    if len(datasets) == 1:
        return datasets[0]
    return ConcatDataset(*datasets)


def get_msd_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                   batch_size: int, task_names: Union[str, List[str]],
                   download: bool = False, **kwargs) -> DataLoader:
    """Get the MSD data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_msd_dataset(path, patch_shape, task_names, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
