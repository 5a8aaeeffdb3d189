"""Janowczyk datasets: nuclei / epithelium / tubule segmentation in H&E
(reference torch_em/data/datasets/histopathology/janowczyk.py).

From https://andrewjanowczyk.com/deep-learning/;
publication: https://doi.org/10.4103/2153-3539.186902
"""

import json
import os
from glob import glob
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = {
    "nuclei": "https://andrewjanowczyk.com/wp-static/nuclei.tgz",
    "epithelium": "https://andrewjanowczyk.com/wp-static/epi.tgz",
    "tubule": "https://andrewjanowczyk.com/wp-static/tubule.tgz",
}
CHECKSUM = {
    "nuclei": "cb881c29d9f0ae5ad1d953160a4e00be70af329e0351eed614d51b4b66c65e6b",
    "epithelium": "5ac91a48de7d4f158f72cfc239b9a465849166397580b95d8f695095f54bcf6d",
    "tubule": "4f3e49d32b993c773a4d437f7483677d6b7c53a1d29f6b0b359a21722fa1f8f3",
}


def _create_split_csv(path, split):
    """Patient-level random splits for the nuclei annotation set."""
    import pandas as pd
    csv_path = os.path.join(path, "janowczyk_split.csv")
    if os.path.exists(csv_path):
        df = pd.read_csv(csv_path)
        df[split] = df[split].apply(lambda x: json.loads(x.replace("'", '"')))
        return df.iloc[0][split]
    patient_ids = [
        os.path.basename(image).split("_original")[0]
        for image in glob(os.path.join(path, "data", "nuclei", "*original.tif"))
    ]
    train_ids, test_ids = util._train_test_split(patient_ids, test_size=0.2)
    train_ids, val_ids = util._train_test_split(train_ids, test_size=0.15)
    split_ids = {"train": train_ids, "val": val_ids, "test": test_ids}
    pd.DataFrame.from_dict([split_ids]).to_csv(csv_path, index=False)
    return split_ids[split]


def get_janowczyk_data(path: Union[os.PathLike, str], annotation: str = "nuclei",
                       download: bool = False) -> str:
    """Download the Janowczyk data for one annotation set
    ('nuclei' / 'epithelium' / 'tubule')."""
    if annotation not in URL:
        raise ValueError(f"'{annotation}' is not a supported annotation.")
    data_dir = os.path.join(path, "data", annotation)
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(path, exist_ok=True)
    tar_path = os.path.join(path, f"{annotation}.tgz")
    util.download_source(tar_path, URL[annotation], download, CHECKSUM[annotation])
    util.unzip_tarfile(tar_path, data_dir, remove=False)
    return data_dir


def get_janowczyk_paths(path: Union[os.PathLike, str], split: Optional[str] = None,
                        annotation: str = "nuclei",
                        download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the Janowczyk images and labels; nuclei masks are
    converted to instances via connected components."""
    Image = _pil_image()

    from ....ops.host import connected_components

    data_dir = get_janowczyk_data(path, annotation, download)
    if annotation == "nuclei":
        split_list = _create_split_csv(path, split) if split is not None else [
            os.path.basename(p).split("_original")[0]
            for p in glob(os.path.join(data_dir, "*original.tif"))
        ]
        raw_paths = [os.path.join(data_dir, f"{n}_original.tif") for n in split_list]
        label_paths = []
        for name in split_list:
            lpath = os.path.join(data_dir, f"{name}_mask.png")
            neu_lpath = lpath.replace("_mask.png", "_preprocessed_labels.tif")
            label_paths.append(neu_lpath)
            if os.path.exists(neu_lpath):
                continue
            label = connected_components(np.asarray(load_image(lpath))).astype("int32")
            Image.fromarray(label, mode="I").save(neu_lpath)
        raw_paths = util.natsorted(raw_paths)
        label_paths = util.natsorted(label_paths)
    else:
        assert split is None, "Only the 'nuclei' annotation set has splits."
        if annotation == "epithelium":
            label_paths = util.natsorted(glob(os.path.join(data_dir, "masks", "*_mask.png")))
            raw_paths = [p.replace("masks" + os.sep, "").replace("_mask.png", ".tif")
                         for p in label_paths]
        else:  # tubule
            label_paths = util.natsorted(glob(os.path.join(data_dir, "*_anno.bmp")))
            raw_paths = [p.replace("_anno", "") for p in label_paths]
    assert len(raw_paths) == len(label_paths)
    return raw_paths, label_paths


def get_janowczyk_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                          split: Optional[str] = None, annotation: str = "nuclei",
                          download: bool = False, **kwargs):
    """Get the Janowczyk dataset for histopathology segmentation."""
    raw_paths, label_paths = get_janowczyk_paths(path, split, annotation, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_janowczyk_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         batch_size: int, split: Optional[str] = None,
                         annotation: str = "nuclei", download: bool = False,
                         **kwargs) -> DataLoader:
    """Get the Janowczyk data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_janowczyk_dataset(path, patch_shape, split=split, annotation=annotation,
                               download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
