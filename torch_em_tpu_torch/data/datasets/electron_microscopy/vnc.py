"""VNC drosophila EM dataset: mitochondria (and synapse) segmentation
(reference torch_em/data/datasets/electron_microscopy/vnc.py).

Publication: https://doi.org/10.6084/m9.figshare.856713.v1
"""

import os
from glob import glob
from shutil import rmtree
from typing import List, Optional, Tuple, Union

import numpy as np

from ... import DataLoader
from ....ops.host import connected_components
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, _pil_image
from .. import util

URL = "https://github.com/unidesigner/groundtruth-drosophila-vnc/archive/refs/heads/master.zip"
CHECKSUM = "f7bd0db03c86b64440a16b60360ad60c0a4411f89e2c021c7ee2c8d6af3d7e86"


def _create_volume(f, key, pattern, process=None):
    Image = _pil_image()

    files = sorted(glob(pattern))
    data = np.stack([np.asarray(Image.open(p)) for p in files])
    if process is not None:
        data = process(data)
    f.create_dataset(key, data=data, compression="gzip")


def get_vnc_data(path: Union[os.PathLike, str], download: bool) -> str:
    """Download the VNC data."""
    h5py = _h5py()

    train_path = os.path.join(path, "vnc_train.h5")
    test_path = os.path.join(path, "vnc_test.h5")
    if os.path.exists(train_path) and os.path.exists(test_path):
        return path
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "vnc.zip")
    util.download_source(zip_path, URL, download, CHECKSUM)
    util.unzip(zip_path, path, remove=True)

    root = os.path.join(path, "groundtruth-drosophila-vnc-master")
    assert os.path.exists(root)
    with h5py.File(train_path, "w") as f:
        _create_volume(f, "raw", os.path.join(root, "stack1", "raw", "*.tif"))
        _create_volume(f, "labels/mitochondria", os.path.join(root, "stack1", "mitochondria", "*.png"),
                       process=connected_components)
        _create_volume(f, "labels/synapses", os.path.join(root, "stack1", "synapses", "*.png"),
                       process=connected_components)
    with h5py.File(test_path, "w") as f:
        _create_volume(f, "raw", os.path.join(root, "stack2", "raw", "*.tif"))
    rmtree(root)
    return path


def get_vnc_mito_paths(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Get the path to the VNC training data."""
    get_vnc_data(path, download)
    return os.path.join(path, "vnc_train.h5")


def get_vnc_mito_dataset(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int, int],
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    download: bool = False,
    **kwargs,
):
    """Get the VNC dataset for mitochondria segmentation."""
    data_path = get_vnc_mito_paths(path, download)
    kwargs = util.ensure_transforms(ndim=3, **kwargs)
    kwargs, _ = util.add_instance_label_transform(
        kwargs, add_binary_target=binary, binary=binary, boundaries=boundaries, offsets=offsets,
    )
    return default_segmentation_dataset(data_path, "raw", data_path, "labels/mitochondria",
                                        patch_shape, **kwargs)


def get_vnc_mito_loader(
    path: Union[os.PathLike, str],
    patch_shape: Tuple[int, int, int],
    batch_size: int,
    offsets: Optional[List[List[int]]] = None,
    boundaries: bool = False,
    binary: bool = False,
    download: bool = False,
    **kwargs,
) -> DataLoader:
    """Get the VNC mitochondria data loader."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_vnc_mito_dataset(
        path, patch_shape, offsets=offsets, boundaries=boundaries, binary=binary,
        download=download, **ds_kwargs,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)


def get_vnc_neuron_loader(path, patch_shape, download=False, **kwargs):
    """Neuron segmentation for VNC is not yet supported (reference vnc.py:162)."""
    raise NotImplementedError
