"""CVZ-Fluo dataset: cell and nucleus segmentation across CODEX / Vectra /
Zeiss fluorescence platforms (reference
torch_em/data/datasets/light_microscopy/cvz_fluo.py).

Hosted on synapse (syn27624812);
publication: https://doi.org/10.1038/s41597-023-02108-z
"""

import os
from glob import glob
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image, load_image
from .. import util

URL = "https://www.synapse.org/Synapse:syn27624812/"


def get_cvz_fluo_data(path: Union[os.PathLike, str], download: bool = False):
    """Download the CVZ-Fluo data (synapse client required)."""
    marker = os.path.join(path, "Annotation Panel Table.xlsx")
    if not os.path.exists(marker):
        os.makedirs(path, exist_ok=True)
        util.download_source_synapse(path, "syn27624812", download)


def _preprocess_labels(label_paths):
    Image = _pil_image()

    from ....ops.host import connected_components

    neu_label_paths = []
    for lpath in label_paths:
        neu_lpath = lpath.replace(".png", ".tif")
        neu_label_paths.append(neu_lpath)
        if os.path.exists(neu_lpath):
            continue
        if not os.path.exists(lpath):  # some published paths carry a leading space
            lpath = str(Path(lpath).parent / f" {os.path.basename(lpath)}")
        label = np.asarray(load_image(lpath))
        Image.fromarray(connected_components(label).astype("int32"), mode="I").save(neu_lpath)
    return neu_label_paths


def get_cvz_fluo_paths(path: Union[os.PathLike, str], stain_choice: str = "cell",
                       data_choice: Optional[str] = None,
                       download: bool = False) -> Tuple[List[str], List[str]]:
    """Get paths to the CVZ-Fluo images and instance labels
    (stain_choice 'cell'/'dapi'; data_choice CODEX/Vectra/Zeiss/None)."""
    get_cvz_fluo_data(path, download)
    if data_choice is None:
        data_choice = "**"
    else:
        if data_choice == "Zeiss" and stain_choice == "dapi":
            raise ValueError("'Zeiss' data does not have DAPI stained images.")
        data_choice = f"{data_choice}/**"
    if stain_choice not in ("cell", "dapi"):
        raise ValueError(f"'{stain_choice}' is not a valid stain choice.")
    raw_paths = util.natsorted(glob(
        os.path.join(path, data_choice, f"*-Crop_{stain_choice.title()}_Png.png"),
        recursive=True))
    label_paths = _preprocess_labels([p.replace("_Png.png", "_Mask_Png.png") for p in raw_paths])
    assert len(raw_paths) == len(label_paths) and len(raw_paths) > 0
    return raw_paths, label_paths


def get_cvz_fluo_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         stain_choice: str = "cell", data_choice: Optional[str] = None,
                         download: bool = False, **kwargs):
    """Get the CVZ-Fluo dataset for cell/nucleus segmentation."""
    raw_paths, label_paths = get_cvz_fluo_paths(path, stain_choice, data_choice, download)
    kwargs = util.ensure_transforms(ndim=2, **kwargs)
    return default_segmentation_dataset(raw_paths, None, label_paths, None, patch_shape,
                                        is_seg_dataset=False, ndim=2, **kwargs)


def get_cvz_fluo_loader(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        batch_size: int, stain_choice: str = "cell",
                        data_choice: Optional[str] = None, download: bool = False,
                        **kwargs) -> DataLoader:
    """Get the CVZ-Fluo data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_cvz_fluo_dataset(path, patch_shape, stain_choice=stain_choice,
                              data_choice=data_choice, download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
