"""NeurIPS CellSeg challenge data: multi-modality cell segmentation
(reference torch_em/data/datasets/light_microscopy/neurips_cell_seg.py).

Challenge: https://neurips22-cellseg.grand-challenge.org/;
publication: https://doi.org/10.1038/s41592-024-02233-6
"""

import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ...raw_image_collection_dataset import RawImageCollectionDataset
from .. import util

URL = {
    "train": "https://zenodo.org/records/10719375/files/Training-labeled.zip",
    "val": "https://zenodo.org/records/10719375/files/Tuning.zip",
    "test": "https://zenodo.org/records/10719375/files/Testing.zip",
    "unlabeled": "https://zenodo.org/records/10719375/files/train-unlabeled-part1.zip",
    "unlabeled_wsi": "https://zenodo.org/records/10719375/files/train-unlabeled-part2.zip",
}
CHECKSUM = {
    "train": "b2383929eb8e99b2716fa0d4e2f6e03983e626a57cf00fe85175869c54aa3592",
    "val": "849423d36bb8fcc2d91a5b189a3b6d93c3d4071c9701eaaa44ba393a510459c4",
    "test": "3379730221f43830d30fddf131750e967c9c9bdf04f98811e852a050eb659ccc",
    "unlabeled": "390b38b398b05e9e5306a024a3bd48ab22e49592cfab3c1a119eab3636b38e0d",
    "unlabeled_wsi": "d1e68eba2918305eab8b846e7578ac14683de970e3fa6a7c2a4a55753be56204",
}
DIR_NAMES = {
    "train": "Training-labeled", "val": "Tuning", "test": "Testing/Public",
    "unlabeled": "release-part1", "unlabeled_wsi": "train-unlabeled-part2",
}


def to_rgb(image):
    """Ensure a channel-first 3-channel image (the challenge mixes grayscale
    and RGB modalities)."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = np.concatenate([image[None]] * 3, axis=0)
    if image.ndim == 3 and image.shape[-1] == 3:
        image = image.transpose(2, 0, 1)
    assert image.ndim == 3 and image.shape[0] == 3, f"{image.shape}"
    return image


def get_neurips_cellseg_data(root: Union[os.PathLike, str], split: str,
                             download: bool = False) -> str:
    """Download the NeurIPS CellSeg data for a split."""
    assert split in URL, f"Invalid split: {split}"
    os.makedirs(root, exist_ok=True)
    target_dir = os.path.join(root, DIR_NAMES[split])
    if not os.path.exists(target_dir):
        zip_path = os.path.join(root, os.path.basename(URL[split]))
        util.download_source(zip_path, URL[split], download, CHECKSUM[split])
        util.unzip(zip_path, root)
    return target_dir


def get_neurips_cellseg_paths(root: Union[os.PathLike, str], split: str,
                              download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the NeurIPS CellSeg images and labels."""
    path = get_neurips_cellseg_data(root, split, download)
    image_paths = sorted(glob(os.path.join(path, "images", "*")))
    label_paths = sorted(glob(os.path.join(path, "labels", "*")))
    assert len(image_paths) == len(label_paths)
    return image_paths, label_paths


def get_neurips_cellseg_supervised_dataset(
    root: Union[os.PathLike, str], split: str, patch_shape: Tuple[int, int],
    make_rgb: bool = True, download: bool = False, **kwargs,
):
    """Get the labeled NeurIPS CellSeg dataset."""
    image_paths, label_paths = get_neurips_cellseg_paths(root, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if make_rgb:
        kwargs["raw_transform"] = _compose_rgb(kwargs.get("raw_transform"))
    return default_segmentation_dataset(image_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=make_rgb,
                                        **kwargs)


def _compose_rgb(raw_transform):
    if raw_transform is None:
        return to_rgb

    def composed(raw):
        return raw_transform(to_rgb(raw))

    return composed


def get_neurips_cellseg_supervised_loader(
    root: Union[os.PathLike, str], split: str, patch_shape: Tuple[int, int], batch_size: int,
    make_rgb: bool = True, download: bool = False, **kwargs,
) -> DataLoader:
    """Get the labeled NeurIPS CellSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_neurips_cellseg_supervised_dataset(root, split, patch_shape, make_rgb=make_rgb,
                                                download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)


def get_neurips_cellseg_unsupervised_dataset(
    root: Union[os.PathLike, str], patch_shape: Tuple[int, int],
    make_rgb: bool = True, use_images: bool = True, use_wsi: bool = False,
    download: bool = False, **kwargs,
):
    """Get the unlabeled NeurIPS CellSeg dataset (images and/or whole-slide
    images)."""
    assert use_images or use_wsi
    image_paths = []
    if use_images:
        folder = get_neurips_cellseg_data(root, "unlabeled", download)
        image_paths.extend(sorted(glob(os.path.join(folder, "*"))))
    if use_wsi:
        folder = get_neurips_cellseg_data(root, "unlabeled_wsi", download)
        image_paths.extend(sorted(glob(os.path.join(folder, "*"))))
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    if make_rgb:
        kwargs["raw_transform"] = _compose_rgb(kwargs.get("raw_transform"))
    kwargs, _ = util.split_kwargs(RawImageCollectionDataset, **kwargs)
    return RawImageCollectionDataset(image_paths, patch_shape, **kwargs)


def get_neurips_cellseg_unsupervised_loader(
    root: Union[os.PathLike, str], patch_shape: Tuple[int, int], batch_size: int,
    make_rgb: bool = True, use_images: bool = True, use_wsi: bool = False,
    download: bool = False, **kwargs,
) -> DataLoader:
    """Get the unlabeled NeurIPS CellSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(RawImageCollectionDataset, **kwargs)
    ds = get_neurips_cellseg_unsupervised_dataset(
        root, patch_shape, make_rgb=make_rgb, use_images=use_images, use_wsi=use_wsi,
        download=download, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
