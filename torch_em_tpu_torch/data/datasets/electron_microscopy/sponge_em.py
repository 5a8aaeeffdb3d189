"""SpongeEM dataset for sponge choanocyte segmentation (reference
torch_em/data/datasets/electron_microscopy/sponge_em.py).

Publication: https://doi.org/10.1101/2023.01.05.522898
"""

import os
from glob import glob
from typing import Optional, Sequence, Tuple, Union

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from .. import util

URL = "https://zenodo.org/record/8150818/files/sponge_em_train_data.zip?download=1"
CHECKSUM = "f1df616cd60f81b91d7642933e9edd74dc6c486b2e546186a7c1e54c67dd32a5"


def get_sponge_em_data(path: Union[os.PathLike, str], download: bool = False) -> Tuple[str, int]:
    """Download the SpongeEM data."""
    n_files = len(glob(os.path.join(path, "*.h5")))
    if n_files == 3:
        return path, n_files
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "data.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path)
    return path, len(glob(os.path.join(path, "*.h5")))


def get_sponge_em_paths(path: Union[os.PathLike, str], sample_ids: Optional[Sequence[int]],
                        download: bool = False):
    """Get paths to the SpongeEM volumes."""
    path, n_files = get_sponge_em_data(path, download)
    if sample_ids is None:
        sample_ids = range(1, n_files + 1)
    return [os.path.join(path, f"train_data_0{i}.h5") for i in sample_ids]


def get_sponge_em_dataset(path: Union[os.PathLike, str], mode: str,
                          patch_shape: Tuple[int, int, int],
                          sample_ids: Optional[Sequence[int]] = None,
                          download: bool = False, **kwargs):
    """Get the SpongeEM dataset (modes: semantic, instances)."""
    assert mode in ("semantic", "instances")
    paths = get_sponge_em_paths(path, sample_ids, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    return default_segmentation_dataset(paths, "volumes/raw", paths, f"volumes/labels/{mode}",
                                        patch_shape, **kwargs)


def get_sponge_em_loader(path: Union[os.PathLike, str], mode: str,
                         patch_shape: Tuple[int, int, int], batch_size: int,
                         sample_ids: Optional[Sequence[int]] = None,
                         download: bool = False, **kwargs) -> DataLoader:
    """Get the SpongeEM data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_sponge_em_dataset(path, mode, patch_shape, sample_ids=sample_ids,
                               download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
