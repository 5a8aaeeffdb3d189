"""Host-side data access: numpy arrays, ``.npy`` files, HDF5 containers, image files, ROI views.

The port's own copy of ``torch_em_tpu/utils/io.py`` but its zarr, N5 and
medical formats: ``load_data`` passes a numpy array through, opens a
``.npy`` file as a read-only memory map, an HDF5 dataset as a lazy h5py
handle (several keys of one container stack as channels) and an image file
(``IMAGE_EXTENSIONS``) as a reader that probes the shape without decoding,
so a dataset reads only the windows it samples; ``load_image`` decodes an
image (a multi-page TIFF as a stack) or memory-maps a ``.npy`` file;
``open_container``, ``get_dataset_shape`` and ``write_data`` serve HDF5,
``.npy`` and images; ``RoiWrapper`` is a lazy region-of-interest view.
h5py, PIL and imageio are imported only inside the functions that need
them, which raise an ``ImportError`` naming the package where it is
missing. zarr and N5 raise ``NotImplementedError``, and so do NIfTI, MHA,
MRC and NRRD files, which wait for the port of ``utils/medical_io.py``.
"""

import os
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["load_data", "load_image", "supports_memmap", "open_container", "get_dataset_shape",
           "write_data", "RoiWrapper", "IMAGE_EXTENSIONS"]

HDF5_EXTENSIONS = (".h5", ".hdf", ".hdf5")
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
NUMPY_EXTENSIONS = (".npy",)
MEDICAL_EXTENSIONS = (".nii", ".nii.gz", ".mha", ".mhd", ".mrc", ".rec", ".nrrd")


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading or writing HDF5 needs h5py, which is not installed") from e
    return h5py


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading image files needs PIL (Pillow), which is not installed") from e
    return Image


def _imageio():
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise ImportError("writing image files needs imageio, which is not installed") from e
    return iio


def _extension(path) -> str:
    return os.path.splitext(str(path))[1].lower()


def _not_ported(path, ext):
    if str(path).lower().endswith(MEDICAL_EXTENSIONS):
        return NotImplementedError(
            f"Reading {ext} data ({path}) is not ported yet: it waits for utils/medical_io.py "
            "(ROADMAP.md, Queue 1 item 10g)."
        )
    return NotImplementedError(
        f"Reading {ext or 'this'} data ({path}) is not ported yet: the port reads numpy arrays, "
        ".npy files, HDF5 and image files; zarr and N5 wait (ROADMAP.md, Queue 1)."
    )


class _PILImageReader:
    """Image file reader that probes shape and dtype through PIL without decoding; the
    pixels are decoded on first access. A multi-page TIFF reads as (n_pages, H, W[, C])."""

    def __init__(self, path: str):
        self.path = path
        self._data = None
        self.shape, self.dtype = self._probe()

    def _probe(self) -> Tuple[Tuple[int, ...], np.dtype]:
        with _pil_image().open(self.path) as im:
            n_frames = getattr(im, "n_frames", 1)
            w, h = im.size
            mode = im.mode
        n_channels = {"L": 0, "I": 0, "I;16": 0, "F": 0, "P": 0, "RGB": 3, "RGBA": 4, "LA": 2}.get(mode, 0)
        dtype = {"F": np.float32, "I": np.int32, "I;16": np.uint16}.get(mode, np.uint8)
        shape = (h, w) if n_channels == 0 else (h, w, n_channels)
        if n_frames > 1:
            shape = (n_frames,) + shape
        return shape, np.dtype(dtype)

    def _load(self) -> np.ndarray:
        if self._data is None:
            self._data = load_image(self.path)
        return self._data

    @property
    def ndim(self):
        return len(self.shape)

    def __getitem__(self, index) -> np.ndarray:
        return self._load()[index]

    def __array__(self, dtype=None, copy=None):
        data = self._load()
        return data.astype(dtype) if dtype is not None else data


def supports_memmap(image_path) -> bool:
    """Whether the shape of this image file can be probed without decoding it."""
    return _extension(image_path) in IMAGE_EXTENSIONS


def load_image(image_path, memmap: bool = True) -> np.ndarray:
    """An image file as a numpy array (a multi-page TIFF as a (n_pages, H, W) stack); a
    ``.npy`` file memory-mapped unless ``memmap`` is False."""
    ext = _extension(image_path)
    if ext in NUMPY_EXTENSIONS:
        return np.load(image_path, mmap_mode="r" if memmap else None)
    if str(image_path).lower().endswith(MEDICAL_EXTENSIONS):
        raise _not_ported(image_path, ext)
    with _pil_image().open(image_path) as im:
        n_frames = getattr(im, "n_frames", 1)
        if n_frames > 1:
            frames = []
            for i in range(n_frames):
                im.seek(i)
                frames.append(np.asarray(im))
            return np.stack(frames)
        return np.asarray(im)


def _lazy_image(image_path):
    if _extension(image_path) in NUMPY_EXTENSIONS:
        return np.load(image_path, mmap_mode="r")
    return _PILImageReader(image_path)


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
    map and an image file as a lazy reader (``key`` must be None for these);
    an HDF5 file with a ``key`` gives the dataset's lazy handle, and with a
    list of keys a lazy (C, *spatial) stack of the datasets. A list of paths
    gives the stack of their images (``key`` None) or a list of datasets.
    """
    if isinstance(path, np.ndarray):
        if key is not None:
            raise ValueError(f"Expected key=None for an in-memory array, got {key}.")
        return path
    if isinstance(path, (list, tuple)):
        if key is None:
            return np.stack([np.asarray(load_image(p)) for p in path])
        keys = key if isinstance(key, (list, tuple)) else [key] * len(path)
        return [load_data(p, k, mode=mode) for p, k in zip(path, keys)]
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
    if ext in IMAGE_EXTENSIONS:
        if key is not None:
            raise ValueError(f"Expected key=None for image file {path}, got {key}.")
        return _lazy_image(path)
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
    """Write an array into an HDF5 container (gzip, replacing ``key``), a ``.npy`` file or an
    image file (imageio)."""
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
    if ext in IMAGE_EXTENSIONS:
        _imageio().imwrite(path, data)
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
