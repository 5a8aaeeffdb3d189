"""Host-side data access: numpy arrays, ``.npy`` files, HDF5 containers, and ROI views.

The part of ``torch_em_tpu/utils/io.py`` the port needs so far:
``load_data`` passes a numpy array through, opens a ``.npy`` file as a
read-only memory map and an HDF5 dataset as a lazy h5py handle (several keys
of one container stack as channels), so a dataset reads only the windows it
samples; ``open_container``, ``get_dataset_shape`` and ``write_data`` serve
HDF5 and ``.npy``; ``RoiWrapper`` is a lazy region-of-interest view. h5py is
imported only inside the functions that read or write HDF5, and they raise
an ``ImportError`` naming it where it is missing. zarr, N5 and image files
are not ported yet and raise ``NotImplementedError``.
"""

import os
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["load_data", "open_container", "get_dataset_shape", "write_data", "RoiWrapper"]

HDF5_EXTENSIONS = (".h5", ".hdf", ".hdf5")
NUMPY_EXTENSIONS = (".npy",)


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading or writing HDF5 needs h5py, which is not installed") from e
    return h5py


def _extension(path) -> str:
    return os.path.splitext(str(path))[1].lower()


def _not_ported(path, ext):
    return NotImplementedError(
        f"Reading {ext or 'this'} data ({path}) is not ported yet: the port reads numpy arrays, "
        ".npy files and HDF5; zarr, N5 and image files wait (ROADMAP.md, Queue 1)."
    )


def open_container(path: Union[str, os.PathLike], mode: str = "r"):
    """Open an HDF5 file, returning its h5py group-like handle."""
    ext = _extension(path)
    if ext in HDF5_EXTENSIONS:
        return _h5py().File(path, mode)
    raise ValueError(f"open_container only handles HDF5; got {ext}.")


def load_data(
    path: Union[str, os.PathLike, np.ndarray],
    key: Optional[Union[str, Sequence[str]]] = None,
    mode: str = "r",
) -> Any:
    """An array-like with ``shape``, ``dtype`` and ``__getitem__`` for ``path``.

    A numpy array passes through; a ``.npy`` file opens as a read-only memory
    map (``key`` must be None for both); an HDF5 file with a ``key`` gives the
    dataset's lazy handle, and with a list of keys a lazy (C, *spatial) stack
    of the datasets.
    """
    if isinstance(path, np.ndarray):
        if key is not None:
            raise ValueError(f"Expected key=None for an in-memory array, got {key}.")
        return path
    if isinstance(key, (list, tuple)):
        return _StackedDatasets([load_data(path, k, mode=mode) for k in key])
    ext = _extension(path)
    if ext in NUMPY_EXTENSIONS:
        if key is not None:
            raise ValueError(f"Expected key=None for the numpy file {path}, got {key}.")
        return np.load(path, mmap_mode="r")
    if ext in HDF5_EXTENSIONS:
        if key is None:
            raise ValueError(f"A key is required to load data from the container file {path}.")
        return open_container(path, mode)[key]
    raise _not_ported(path, ext)


class _StackedDatasets:
    """Lazy channel stack over same-shaped datasets of one container: shape (C, *spatial),
    and slicing stacks the datasets' slices."""

    def __init__(self, datasets):
        if not datasets:
            raise ValueError("no datasets to stack")
        shapes = {tuple(ds.shape) for ds in datasets}
        if len(shapes) != 1:
            raise ValueError(f"Inconsistent shapes for stacked keys: {shapes}")
        self._datasets = datasets
        self.shape = (len(datasets),) + tuple(datasets[0].shape)
        self.dtype = datasets[0].dtype
        self.ndim = len(self.shape)

    def __getitem__(self, index):
        if not isinstance(index, tuple):
            index = (index,)
        chan = index[0] if len(index) > 0 else slice(None)
        rest = index[1:] if len(index) > 1 else (slice(None),) * (self.ndim - 1)
        if isinstance(chan, int):
            return np.asarray(self._datasets[chan][rest])
        selected = self._datasets[chan] if isinstance(chan, slice) else \
            [self._datasets[i] for i in np.atleast_1d(chan)]
        return np.stack([np.asarray(ds[rest]) for ds in selected])


def write_data(path: Union[str, os.PathLike], key: Optional[str], data: np.ndarray,
               chunks: Optional[Tuple[int, ...]] = None) -> None:
    """Write an array into an HDF5 container (gzip, replacing ``key``) or a ``.npy`` file."""
    ext = _extension(path)
    if ext in HDF5_EXTENSIONS:
        with _h5py().File(path, "a") as f:
            if key in f:
                del f[key]
            f.create_dataset(key, data=data, chunks=chunks, compression="gzip")
        return
    if ext in NUMPY_EXTENSIONS:
        np.save(path, data)
        return
    raise _not_ported(path, ext)


def get_dataset_shape(path: Union[str, os.PathLike], key: Optional[str] = None) -> Tuple[int, ...]:
    """The shape of a dataset, without reading it."""
    return tuple(load_data(path, key).shape)


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
