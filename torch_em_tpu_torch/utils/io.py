"""Host-side data access: numpy arrays and ``.npy`` files, and ROI views.

The part of ``torch_em_tpu/utils/io.py`` the port needs so far:
``load_data`` passes a numpy array through and opens a ``.npy`` file as a
read-only memory map, so a dataset reads only the windows it samples;
``RoiWrapper`` is a lazy region-of-interest view. HDF5, zarr, N5 and image
files are not ported yet: the machine with the card has no h5py, and the
port imports none of it. Asking for them raises.
"""

import os
from typing import Any, Optional, Tuple, Union

import numpy as np

__all__ = ["load_data", "RoiWrapper"]

NUMPY_EXTENSIONS = (".npy",)


def load_data(path: Union[str, os.PathLike, np.ndarray], key: Optional[str] = None) -> Any:
    """An array-like with ``shape``, ``dtype`` and ``__getitem__`` for ``path``.

    A numpy array passes through; a ``.npy`` file opens as a read-only memory
    map. ``key`` must be None for both.
    """
    if isinstance(path, np.ndarray):
        if key is not None:
            raise ValueError(f"Expected key=None for an in-memory array, got {key}.")
        return path
    ext = os.path.splitext(str(path))[1].lower()
    if ext in NUMPY_EXTENSIONS:
        if key is not None:
            raise ValueError(f"Expected key=None for the numpy file {path}, got {key}.")
        return np.load(path, mmap_mode="r")
    raise NotImplementedError(
        f"Reading {ext or 'this'} data ({path}) is not ported yet: the port reads numpy "
        "arrays and .npy files; HDF5, zarr, N5 and image files wait (ROADMAP.md, Queue 1)."
    )


class RoiWrapper:
    """Lazy region-of-interest view over an array-like; indexes in ROI coordinates without copying."""

    def __init__(self, volume, roi: Tuple[slice, ...]):
        if len(roi) > getattr(volume, "ndim", len(volume.shape)):
            raise ValueError(f"ROI has more dimensions ({len(roi)}) than the data ({volume.ndim}).")
        full = tuple(
            slice(*r.indices(volume.shape[i])) if isinstance(r, slice) else slice(int(r), int(r) + 1)
            for i, r in enumerate(roi)
        )
        full = full + tuple(slice(0, s) for s in volume.shape[len(full):])
        self._volume = volume
        self._roi = full
        self.shape = tuple(r.stop - r.start for r in full)
        self.dtype = volume.dtype

    @property
    def ndim(self):
        return len(self.shape)

    def __getitem__(self, index):
        if not isinstance(index, tuple):
            index = (index,)
        index = index + tuple(slice(None) for _ in range(self.ndim - len(index)))
        mapped = []
        for ix, r, sh in zip(index, self._roi, self.shape):
            if isinstance(ix, slice):
                start, stop, _ = ix.indices(sh)
                mapped.append(slice(r.start + start, r.start + stop))
            else:
                mapped.append(r.start + int(ix))
        return self._volume[tuple(mapped)]
