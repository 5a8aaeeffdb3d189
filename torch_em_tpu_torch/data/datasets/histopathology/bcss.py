"""BCSS dataset: breast cancer semantic tissue segmentation in H&E
(reference torch_em/data/datasets/histopathology/bcss.py).

The data must be downloaded manually from the drive folder / the
https://github.com/PathologyDataScience/BCSS repository;
publication: https://doi.org/10.1093/bioinformatics/btz083
"""

import os
import shutil
from glob import glob
from pathlib import Path
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://drive.google.com/drive/folders/1zqbdkQF8i5cEmZOGmbdQm-EP8dRYtvss?usp=sharing"

# the held-out test slides used by the reference
TEST_LIST = [
    "TCGA-A2-A0SX-DX1_xmin53791_ymin56683_MPP-0.2500", "TCGA-BH-A0BG-DX1_xmin64019_ymin24975_MPP-0.2500",
    "TCGA-AR-A1AI-DX1_xmin38671_ymin10616_MPP-0.2500", "TCGA-E2-A574-DX1_xmin54962_ymin47475_MPP-0.2500",
    "TCGA-GM-A3XL-DX1_xmin29910_ymin15820_MPP-0.2500", "TCGA-E2-A14X-DX1_xmin88836_ymin66393_MPP-0.2500",
    "TCGA-A2-A04P-DX1_xmin104246_ymin48517_MPP-0.2500", "TCGA-E2-A14N-DX1_xmin21383_ymin66838_MPP-0.2500",
    "TCGA-EW-A1OV-DX1_xmin126026_ymin65132_MPP-0.2500", "TCGA-S3-AA15-DX1_xmin55486_ymin28926_MPP-0.2500",
    "TCGA-LL-A5YO-DX1_xmin36631_ymin44396_MPP-0.2500", "TCGA-GI-A2C9-DX1_xmin20882_ymin11843_MPP-0.2500",
    "TCGA-BH-A0BW-DX1_xmin42346_ymin30843_MPP-0.2500", "TCGA-E2-A1B6-DX1_xmin16266_ymin50634_MPP-0.2500",
    "TCGA-AO-A0J2-DX1_xmin33561_ymin14515_MPP-0.2500",
]


def _get_image_and_label_paths(path):
    if os.path.exists(os.path.join(path, "images")):
        return (sorted(glob(os.path.join(path, "images", "*"))),
                sorted(glob(os.path.join(path, "masks", "*"))))
    root = os.path.join(path, "0_Public-data-Amgad2019_0.25MPP")
    if os.path.exists(os.path.join(root, "rgbs_colorNormalized")):
        return (sorted(glob(os.path.join(root, "rgbs_colorNormalized", "*"))),
                sorted(glob(os.path.join(root, "masks", "*"))))
    raise ValueError(
        "Please check the image directory; expected 'images' (git repo) or "
        "'rgbs_colorNormalized' (gdrive) folders."
    )


def get_bcss_data(path: Union[os.PathLike, str], download: bool = False):
    """Sort the manually downloaded BCSS data into train/test folders
    (the published TEST_LIST slides form the test split)."""
    if download:
        raise NotImplementedError(
            f"Please download the BCSS data manually from '{URL}' or via the BCSS git repo."
        )
    if os.path.exists(os.path.join(path, "train")) and os.path.exists(os.path.join(path, "test")):
        return
    all_image_paths, all_label_paths = _get_image_and_label_paths(path)
    for split in ("train", "test"):
        os.makedirs(os.path.join(path, split, "images"), exist_ok=True)
        os.makedirs(os.path.join(path, split, "masks"), exist_ok=True)
    for image_path, label_path in zip(all_image_paths, all_label_paths):
        split = "test" if Path(image_path).stem in TEST_LIST else "train"
        shutil.copy(image_path, os.path.join(path, split, "images",
                                             os.path.split(image_path)[-1]))
        shutil.copy(label_path, os.path.join(path, split, "masks",
                                             os.path.split(label_path)[-1]))


def get_bcsss_paths(path: Union[os.PathLike, str], split: Optional[str] = None,
                    val_fraction: float = 0.2,
                    download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the BCSS images and tissue masks."""
    get_bcss_data(path, download)
    if split is None:
        image_paths = sorted(glob(os.path.join(path, "*", "images", "*")))
        label_paths = sorted(glob(os.path.join(path, "*", "masks", "*")))
    else:
        assert split in ("train", "val", "test")
        folder = "test" if split == "test" else "train"
        image_paths = sorted(glob(os.path.join(path, folder, "images", "*")))
        label_paths = sorted(glob(os.path.join(path, folder, "masks", "*")))
        if split in ("train", "val"):
            tr_im, va_im, tr_lb, va_lb = util._train_test_split(
                image_paths, label_paths, test_size=val_fraction, random_state=42)
            image_paths = tr_im if split == "train" else va_im
            label_paths = tr_lb if split == "train" else va_lb
    assert len(image_paths) == len(label_paths)
    return image_paths, label_paths


def get_bcss_dataset(path: Union[os.PathLike, str], patch_shape, split: Optional[str] = None,
                     val_fraction: float = 0.2, download: bool = False, **kwargs):
    """Get the BCSS dataset for tissue segmentation."""
    image_paths, label_paths = get_bcsss_paths(path, split, val_fraction, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(image_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, with_channels=True, **kwargs)


def get_bcss_loader(path: Union[os.PathLike, str], patch_shape, batch_size: int,
                    split: Optional[str] = None, val_fraction: float = 0.2,
                    download: bool = False, **kwargs) -> DataLoader:
    """Get the BCSS data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_bcss_dataset(path, patch_shape, split=split, val_fraction=val_fraction,
                          download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
