"""VGG-HeLa dataset: HeLa cell detection in phase-contrast microscopy
(reference torch_em/data/datasets/light_microscopy/vgg_hela.py).

The labels are point annotations (one pixel per cell), rasterized from the
published MATLAB ground truth. Publication:
https://www.robots.ox.ac.uk/~vgg/publications/2012/Arteta12/
"""

import os
from glob import glob
from shutil import rmtree
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = "https://www.robots.ox.ac.uk/~vgg/software/cell_detection/downloads/CellDetect_v1.0.tar.gz"
CHECKSUM = "09825d6a8e287ddf2c4b1ef3d2f62585ec6876e3bfcd4b9bbcd3dd300e4be282"


def get_vgg_hela_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Download and convert the VGG-HeLa data."""
    Image = _pil_image()
    from scipy.io import loadmat

    os.makedirs(path, exist_ok=True)
    train_path, test_path = os.path.join(path, "train"), os.path.join(path, "test")
    if os.path.exists(train_path) and os.path.exists(test_path):
        return path

    tar_path = os.path.join(path, "cell_detect.tar.gz")
    util.download_source(tar_path, URL, download, CHECKSUM)
    util.unzip_tarfile(tar_path, path, True)
    extracted = os.path.join(path, "CellDetect_v1.0")
    assert os.path.exists(extracted), extracted

    for split_in, out_folder in (("trainPhasecontrast", train_path),
                                 ("testPhasecontrast", test_path)):
        out_im_folder = os.path.join(out_folder, "images")
        out_label_folder = os.path.join(out_folder, "labels")
        os.makedirs(out_im_folder, exist_ok=True)
        os.makedirs(out_label_folder, exist_ok=True)

        split_root = os.path.join(extracted, "phasecontrast", split_in)
        image_files = sorted(glob(os.path.join(split_root, "*.pgm")))
        mat_files = sorted(glob(os.path.join(split_root, "*.mat")))
        for ii, (im_file, mat_file) in enumerate(zip(image_files, mat_files), 1):
            im = np.asarray(load_image(im_file))
            coordinates = loadmat(mat_file)["gt"] - 1
            labels = np.zeros(im.shape, dtype="uint8")
            labels[coordinates[:, 1], coordinates[:, 0]] = 1
            Image.fromarray(im).save(os.path.join(out_im_folder, f"im{ii:02}.tif"))
            Image.fromarray(labels).save(os.path.join(out_label_folder, f"im{ii:02}.tif"))

    rmtree(extracted)
    return path


def get_vgg_hela_paths(path: Union[os.PathLike, str], split: str,
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the VGG-HeLa images and point labels."""
    assert split in ("train", "test")
    get_vgg_hela_data(path, download)
    image_paths = sorted(glob(os.path.join(path, split, "images", "*.tif")))
    label_paths = sorted(glob(os.path.join(path, split, "labels", "*.tif")))
    return image_paths, label_paths


def get_vgg_hela_dataset(path: Union[os.PathLike, str], split: str,
                         patch_shape: Tuple[int, int], download: bool = False, **kwargs):
    """Get the VGG-HeLa dataset for cell detection."""
    image_paths, label_paths = get_vgg_hela_paths(path, split, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(image_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_vgg_hela_loader(path: Union[os.PathLike, str], split: str,
                        patch_shape: Tuple[int, int], batch_size: int,
                        download: bool = False, **kwargs) -> DataLoader:
    """Get the VGG-HeLa data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_vgg_hela_dataset(path, split, patch_shape, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
