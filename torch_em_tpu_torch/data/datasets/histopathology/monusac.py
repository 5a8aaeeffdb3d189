"""MoNuSAC dataset: multi-organ nucleus segmentation in H&E
(reference torch_em/data/datasets/histopathology/monusac.py).

Challenge: https://monusac-2020.grand-challenge.org/Data/;
publication: https://doi.org/10.1109/TMI.2021.3085712
"""

import os
import shutil
from glob import glob
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = {
    "train": "https://drive.google.com/uc?export=download&id=1lxMZaAPSpEHLSxGA9KKMt_r-4S8dwLhq",
    "test": "https://drive.google.com/uc?export=download&id=1G54vsOdxWY1hG7dzmkeK3r0xz9s-heyQ",
}
CHECKSUM = {
    "train": "5b7cbeb34817a8f880d3fddc28391e48d3329a91bf3adcbd131ea149a725cd92",
    "test": "bcbc38f6bf8b149230c90c29f3428cc7b2b76f8acd7766ce9fc908fc896c2674",
}

# per-organ patient lists (from the challenge's published data description)
ORGAN_SPLITS = {
    "train": {
        "lung": ["TCGA-55-1594", "TCGA-69-7760", "TCGA-69-A59K", "TCGA-73-4668", "TCGA-78-7220",
                 "TCGA-86-7713", "TCGA-86-8672", "TCGA-L4-A4E5", "TCGA-MP-A4SY", "TCGA-MP-A4T7"],
        "kidney": ["TCGA-5P-A9K0", "TCGA-B9-A44B", "TCGA-B9-A8YI", "TCGA-DW-7841", "TCGA-EV-5903",
                   "TCGA-F9-A97G", "TCGA-G7-A8LD", "TCGA-MH-A560", "TCGA-P4-AAVK", "TCGA-SX-A7SR",
                   "TCGA-UZ-A9PO", "TCGA-UZ-A9PU"],
        "breast": ["TCGA-A2-A0CV", "TCGA-A2-A0ES", "TCGA-B6-A0WZ", "TCGA-BH-A18T", "TCGA-D8-A1X5",
                   "TCGA-E2-A154", "TCGA-E9-A22B", "TCGA-E9-A22G", "TCGA-EW-A6SD", "TCGA-S3-AA11"],
        "prostate": ["TCGA-EJ-5495", "TCGA-EJ-5505", "TCGA-EJ-5517", "TCGA-G9-6342", "TCGA-G9-6499",
                     "TCGA-J4-A67Q", "TCGA-J4-A67T", "TCGA-KK-A59X", "TCGA-KK-A6E0", "TCGA-KK-A7AW",
                     "TCGA-V1-A8WL", "TCGA-V1-A9O9", "TCGA-X4-A8KQ", "TCGA-YL-A9WY"],
    },
    "test": {
        "lung": ["TCGA-49-6743", "TCGA-50-6591", "TCGA-55-7570", "TCGA-55-7573",
                 "TCGA-73-4662", "TCGA-78-7152", "TCGA-MP-A4T7"],
        "kidney": ["TCGA-2Z-A9JG", "TCGA-2Z-A9JN", "TCGA-DW-7838", "TCGA-DW-7963",
                   "TCGA-F9-A8NY", "TCGA-IZ-A6M9", "TCGA-MH-A55W"],
        "breast": ["TCGA-A2-A04X", "TCGA-A2-A0ES", "TCGA-D8-A3Z6", "TCGA-E2-A108", "TCGA-EW-A6SB"],
        "prostate": ["TCGA-G9-6356", "TCGA-G9-6367", "TCGA-VP-A87E", "TCGA-VP-A87H",
                     "TCGA-X4-A8KS", "TCGA-YL-A9WL"],
    },
}


def _get_patient_id(path, split_wrt="-01Z-00-"):
    return Path(path).stem.split(split_wrt)[0]


def _process_monusac(path, split):
    """Extract per-patient tif images + xml annotations into flat
    images/<split> and labels/<split> folders (xml rasterized)."""
    Image = _pil_image()

    util.unzip(os.path.join(path, f"monusac_{split}.zip"), path)
    root_img_save_dir = os.path.join(path, "images", split)
    root_label_save_dir = os.path.join(path, "labels", split)
    os.makedirs(root_img_save_dir, exist_ok=True)
    os.makedirs(root_label_save_dir, exist_ok=True)

    for patient_dir in sorted(glob(os.path.join(path, "MoNuSAC*", "*"))):
        all_img = sorted(glob(os.path.join(patient_dir, "*.tif")))
        all_xml = sorted(glob(os.path.join(patient_dir, "*.xml")))
        if len(all_img) != len(all_xml):
            # some test inputs only ship as svs scans
            for svs_path in sorted(glob(os.path.join(patient_dir, "*.svs"))):
                tif_path = os.path.splitext(svs_path)[0] + ".tif"
                if not os.path.exists(tif_path):
                    img_array = util.convert_svs_to_array(svs_path)
                    Image.fromarray(img_array).save(tif_path)
            all_img = sorted(glob(os.path.join(patient_dir, "*.tif")))
        assert len(all_img) == len(all_xml)
        for img_path, xml_path in zip(all_img, all_xml):
            shape = np.asarray(load_image(img_path)).shape[:2]
            img_id = os.path.split(img_path)[-1]
            shutil.move(img_path, os.path.join(root_img_save_dir, img_id))
            label = util.generate_labeled_array_from_xml(shape=shape, xml_file=xml_path)
            Image.fromarray(label.astype("int32"), mode="I").save(
                os.path.join(root_label_save_dir, f"{img_id.split('.')[0]}.tif"))
    extracted = glob(os.path.join(path, "MoNuSAC*"))
    if extracted:
        shutil.rmtree(extracted[0])


def get_monusac_data(path: Union[os.PathLike, str], split: str, download: bool = False):
    """Download and preprocess the MoNuSAC data for a split ('train'/'test')."""
    assert split in ("train", "test"), "Please choose from train/test"
    im_path = os.path.join(path, "images", split)
    label_path = os.path.join(path, "labels", split)
    if os.path.exists(im_path) and os.path.exists(label_path):
        return
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, f"monusac_{split}.zip")
    util.download_source_gdrive(zip_path, URL[split], download, CHECKSUM[split])
    _process_monusac(path, split)


def get_monusac_paths(path: Union[os.PathLike, str], split: str,
                      organ_type: Optional[List[str]] = None,
                      download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the MoNuSAC images and labels, optionally filtered by
    organ types."""
    get_monusac_data(path, split, download)
    image_paths = sorted(glob(os.path.join(path, "images", split, "*")))
    label_paths = sorted(glob(os.path.join(path, "labels", split, "*")))
    if organ_type is not None:
        patient_ids = [pid for organ in organ_type for pid in ORGAN_SPLITS[split][organ]]
        image_paths = [p for p in image_paths if _get_patient_id(p) in patient_ids]
        label_paths = [p for p in label_paths if _get_patient_id(p) in patient_ids]
    assert len(image_paths) == len(label_paths)
    return image_paths, label_paths


def get_monusac_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        split: str, organ_type: Optional[List[str]] = None,
                        offsets=None, boundaries: bool = False, binary: bool = False,
                        download: bool = False, **kwargs):
    """Get the MoNuSAC dataset for nucleus segmentation."""
    image_paths, label_paths = get_monusac_paths(path, split, organ_type, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=True, binary=binary, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(image_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_monusac_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                       batch_size: int, split: str,
                       organ_type: Optional[List[str]] = None, offsets=None,
                       boundaries: bool = False, binary: bool = False,
                       download: bool = False, **kwargs) -> DataLoader:
    """Get the MoNuSAC data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_monusac_dataset(path, patch_shape, split, organ_type=organ_type, offsets=offsets,
                             boundaries=boundaries, binary=binary, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
