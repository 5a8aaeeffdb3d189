"""MoNuSeg nucleus segmentation in H&E histopathology (reference
torch_em/data/datasets/histopathology/monuseg.py).

Publication: https://doi.org/10.1109/TMI.2017.2677499
"""

import os
from glob import glob
from typing import List, Optional, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util
from ....utils.io import _pil_image

URL = {
    "train": "https://drive.google.com/uc?export=download&id=1ZgqFJomqQGNnsx7w7QBzQQMVA16lbVCA",
    "test": "https://drive.google.com/uc?export=download&id=1NKkSQ5T0ZNQ8aUhh0a8Dt2YKYCQXIViw",
}
CHECKSUM = {
    "train": "25d3d3185bb2970b397cafa72eb664c9b4d24294aee382e7e3df9885affce742",
    "test": "13e522387ae8b1bcc0530e13ff9c7b4d91ec74959ef6f6e57747368d7ee6f88a",
}
ORGAN_SPLITS = {
    "breast": ["TCGA-A7-A13E-01Z-00-DX1", "TCGA-A7-A13F-01Z-00-DX1", "TCGA-AR-A1AK-01Z-00-DX1",
               "TCGA-AR-A1AS-01Z-00-DX1", "TCGA-E2-A1B5-01Z-00-DX1", "TCGA-E2-A14V-01Z-00-DX1"],
    "kidney": ["TCGA-B0-5711-01Z-00-DX1", "TCGA-HE-7128-01Z-00-DX1", "TCGA-HE-7129-01Z-00-DX1",
               "TCGA-HE-7130-01Z-00-DX1", "TCGA-B0-5710-01Z-00-DX1", "TCGA-B0-5698-01Z-00-DX1"],
    "liver": ["TCGA-18-5592-01Z-00-DX1", "TCGA-38-6178-01Z-00-DX1", "TCGA-49-4488-01Z-00-DX1",
              "TCGA-50-5931-01Z-00-DX1", "TCGA-21-5784-01Z-00-DX1", "TCGA-21-5786-01Z-00-DX1"],
    "prostate": ["TCGA-G9-6336-01Z-00-DX1", "TCGA-G9-6348-01Z-00-DX1", "TCGA-G9-6356-01Z-00-DX1",
                 "TCGA-G9-6363-01Z-00-DX1", "TCGA-CH-5767-01Z-00-DX1", "TCGA-G9-6362-01Z-00-DX1"],
}


def _process_monuseg(path, split):
    """Rasterize the xml annotations and save images/labels as png."""
    import numpy as np
    Image = _pil_image()

    image_folder = os.path.join(path, split, "images")
    label_folder = os.path.join(path, split, "labels")
    if os.path.exists(image_folder) and os.path.exists(label_folder):
        return
    os.makedirs(image_folder, exist_ok=True)
    os.makedirs(label_folder, exist_ok=True)
    root = os.path.join(path, "MoNuSeg 2018 Training Data" if split == "train"
                        else "MoNuSegTestData")
    tif_paths = sorted(glob(os.path.join(root, "**", "*.tif"), recursive=True))
    for tif_path in tif_paths:
        name = os.path.splitext(os.path.basename(tif_path))[0]
        xml_path = tif_path.replace(".tif", ".xml")
        if not os.path.exists(xml_path):
            cands = glob(os.path.join(root, "**", f"{name}.xml"), recursive=True)
            if not cands:
                continue
            xml_path = cands[0]
        image = np.asarray(Image.open(tif_path))
        labels = util.generate_labeled_array_from_xml(image.shape[:2], xml_path)
        Image.fromarray(image).save(os.path.join(image_folder, f"{name}.png"))
        Image.fromarray(labels.astype("int32"), mode="I").save(
            os.path.join(label_folder, f"{name}.png"))


def get_monuseg_data(path: Union[os.PathLike, str], split: str, download: bool = False) -> None:
    """Download the MoNuSeg data (google drive; requires gdown)."""
    assert split in ("train", "test")
    if os.path.exists(os.path.join(path, split, "images")):
        return
    os.makedirs(path, exist_ok=True)
    extracted = os.path.join(path, "MoNuSeg 2018 Training Data" if split == "train"
                             else "MoNuSegTestData")
    if not os.path.exists(extracted):
        zip_path = os.path.join(path, f"monuseg_{split}.zip")
        util.download_source_gdrive(zip_path, URL[split], download=download,
                                    checksum=CHECKSUM[split])
        util.unzip(zip_path, path)
    _process_monuseg(path, split)


def get_monuseg_paths(path: Union[os.PathLike, str], split: str,
                      organ_type: Optional[List[str]] = None, download: bool = False):
    """Get paths to the MoNuSeg images and labels."""
    get_monuseg_data(path, split, download)
    image_paths = sorted(glob(os.path.join(path, split, "images", "*.png")))
    label_paths = sorted(glob(os.path.join(path, split, "labels", "*.png")))
    if organ_type is not None:
        assert split == "train", "Organ splits are only available for the train split."
        names = [n for organ in organ_type for n in ORGAN_SPLITS[organ]]
        image_paths = [p for p in image_paths
                       if os.path.splitext(os.path.basename(p))[0] in names]
        label_paths = [p for p in label_paths
                       if os.path.splitext(os.path.basename(p))[0] in names]
    return image_paths, label_paths


def get_monuseg_dataset(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int],
    split: str,
    organ_type: Optional[List[str]] = None,
    download: bool = False,
    offsets=None,
    boundaries: bool = False,
    binary: bool = False,
    **kwargs,
):
    """Get the MoNuSeg dataset for nucleus segmentation."""
    image_paths, label_paths = get_monuseg_paths(path, split, organ_type, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(
        image_paths, None, label_paths, None, patch_shape, is_seg_dataset=False, ndim=2, **kwargs,
    )


def get_monuseg_loader(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int],
    batch_size: int,
    split: str,
    organ_type: Optional[List[str]] = None,
    download: bool = False,
    offsets=None,
    boundaries: bool = False,
    binary: bool = False,
    **kwargs,
) -> DataLoader:
    """Get the MoNuSeg data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_monuseg_dataset(
        path, patch_shape, split, organ_type=organ_type, download=download, offsets=offsets,
        boundaries=boundaries, binary=binary, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
