"""DeepBacs bacteria segmentation datasets (reference
torch_em/data/datasets/light_microscopy/deepbacs.py).

Publication: https://doi.org/10.1038/s42003-022-03634-z
"""

import os
from glob import glob
from typing import Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URLS = {
    "s_aureus": "https://zenodo.org/record/5550933/files/DeepBacs_Data_Segmentation_Staph_Aureus_dataset.zip?download=1",  # noqa
    "e_coli": "https://zenodo.org/record/5550935/files/DeepBacs_Data_Segmentation_E.coli_Brightfield_dataset.zip?download=1",  # noqa
    "e_coli_stationary": "https://zenodo.org/records/6400327/files/DeepBacs_Data_Segmentation_Ecoli_stationary_phase.zip?download=1",  # noqa
    "b_subtilis": "https://zenodo.org/record/5639253/files/Multilabel_U-Net_dataset_B.subtilis.zip?download=1",
    "mixed": "https://zenodo.org/record/5551009/files/DeepBacs_Data_Segmentation_StarDist_MIXED_dataset.zip?download=1",  # noqa
}
CHECKSUMS = {
    "s_aureus": "4047792f1248ee82fce34121d0ade84828e55db5a34656cc25beec46eacaf307",
    "e_coli": "f812a2f814c3875c78fcc1609a2e9b34c916c7a9911abbf8117f423536ef1c17",
    "e_coli_stationary": None,
    "b_subtilis": None,
    "mixed": "2730e6b391637d6dc05bbc7b8c915fd8184d835ac3611e13f23ac6f10f86c2a0",
}


def get_deepbacs_data(path: Union[os.PathLike, str], bac_type: str, download: bool) -> str:
    """Download a DeepBacs dataset."""
    bac_types = list(URLS.keys())
    assert bac_type in bac_types, f"{bac_type} is not in {bac_types}"
    data_folder = os.path.join(path, bac_type)
    if os.path.exists(data_folder):
        return data_folder
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, f"{bac_type}.zip")
    util.download_source(zip_path, URLS[bac_type], download, checksum=CHECKSUMS[bac_type])
    util.unzip(zip_path, data_folder, remove=True)
    return data_folder


def get_deepbacs_paths(path: Union[os.PathLike, str], bac_type: str, split: str,
                       download: bool = False):
    """Get paths to the DeepBacs images and labels."""
    data_folder = get_deepbacs_data(path, bac_type, download)
    # the archives use either 'training'/'test' or 'train'/'test' layouts
    split_names = {"train": ("training", "train"), "test": ("test",)}[split]
    image_paths, label_paths = [], []
    for split_name in split_names:
        for source_folder in ("source", "img", "images"):
            cands = sorted(glob(os.path.join(data_folder, split_name, source_folder, "*")))
            if cands:
                image_paths = cands
                break
        for target_folder in ("target", "masks", "labels"):
            cands = sorted(glob(os.path.join(data_folder, split_name, target_folder, "*")))
            if cands:
                label_paths = cands
                break
        if image_paths and label_paths:
            break
    assert len(image_paths) == len(label_paths) and image_paths, \
        f"Could not find images/labels in {data_folder}"
    return image_paths, label_paths


def get_deepbacs_dataset(
    path: Union[os.PathLike, str],
    split: str,
    patch_shape: Tuple[int, int],
    bac_type: str = "mixed",
    download: bool = False,
    **kwargs,
):
    """Get a DeepBacs dataset for bacteria segmentation."""
    assert split in ("train", "test")
    image_paths, label_paths = get_deepbacs_paths(path, bac_type, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(
        image_paths, None, label_paths, None, patch_shape, is_seg_dataset=False, ndim=2, **kwargs,
    )


def get_deepbacs_loader(
    path: Union[os.PathLike, str],
    split: str,
    patch_shape: Tuple[int, int],
    batch_size: int,
    bac_type: str = "mixed",
    download: bool = False,
    **kwargs,
) -> DataLoader:
    """Get a DeepBacs data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_deepbacs_dataset(path, split, patch_shape, bac_type=bac_type, download=download,
                              **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
