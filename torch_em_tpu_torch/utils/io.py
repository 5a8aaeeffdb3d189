"""Host-side data access: numpy arrays, ``.npy`` files, HDF5, zarr and N5 containers, image files,
ROI views.

The port's own copy of ``torch_em_tpu/utils/io.py``: ``load_data`` passes a
numpy array through, opens a ``.npy`` file as a read-only memory map, an
HDF5 dataset as a lazy ``utils/hdf5.py`` handle (several keys of one container
stack as channels), a zarr or N5 dataset as a lazy ``LazyTensorStore`` and an image
file (``IMAGE_EXTENSIONS``) as a reader that probes the shape without
decoding, so a dataset reads only the windows it samples; ``load_image``
decodes an image (a multi-page TIFF as a stack) or memory-maps a ``.npy``
file; ``open_container`` opens an HDF5 file; ``get_dataset_shape`` and
``write_data`` serve every container format, ``.npy`` and images;
``RoiWrapper`` is a lazy region-of-interest view. N5 keeps its
``dimensions`` and ``blockSize`` column-major on disk, and the store is read
and written through its transpose, in C order. HDF5 goes through the port's own
reader and writer (``utils/hdf5.py``, numpy and zlib), never h5py; zarr and N5 through
``utils/zarr_n5.py`` (numpy, the standard library's codecs and the native blosc build),
never tensorstore, whose name ``LazyTensorStore`` keeps as the JAX package's does; image files
are read and written through PIL (with no imageio), imported only inside the functions that
need it, which raise an ``ImportError`` naming it where it is missing. ``write_data`` writes no
medical format (``medical_io``'s writers do), as in the JAX package.
"""

import os
import threading
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np

from . import zarr_n5

__all__ = ["load_data", "load_image", "supports_memmap", "open_container", "get_dataset_shape",
           "write_data", "LazyTensorStore", "RoiWrapper", "IMAGE_EXTENSIONS"]

HDF5_EXTENSIONS = (".h5", ".hdf", ".hdf5")
ZARR_EXTENSIONS = (".zarr", ".zr")
N5_EXTENSIONS = (".n5",)
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
NUMPY_EXTENSIONS = (".npy",)
MEDICAL_EXTENSIONS = (".nii", ".nii.gz", ".mha", ".mhd", ".mrc", ".rec", ".nrrd")


def _h5py():
    """The port's HDF5 module (``utils/hdf5.py``): the subset of h5py's API that the port uses
    (``File``, ``create_dataset``, ``attrs``, ...), so a reader's ``h5py = _h5py()`` reads as before."""
    from . import hdf5

    return hdf5


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading image files needs PIL (Pillow), which is not installed") from e
    return Image


def _pil_draw():
    try:
        from PIL import ImageDraw
    except ImportError as e:
        raise ImportError("drawing annotations needs PIL (Pillow), which is not installed") from e
    return ImageDraw


def _extension(path) -> str:
    return os.path.splitext(str(path))[1].lower()


# the lazy zarr or N5 array (``mode`` "r" reads; "a" or "w" also writes windows into the existing array)
LazyTensorStore = zarr_n5.ChunkedArray


def _medical_reader(path, extensions):
    """The ``medical_io`` reader of ``path`` among ``extensions``, or None."""
    from . import medical_io

    name = str(path).lower()
    readers = {".nii": medical_io.load_nifti, ".nii.gz": medical_io.load_nifti, ".mha": medical_io.load_mha,
               ".mhd": medical_io.load_mha, ".mrc": medical_io.load_mrc, ".rec": medical_io.load_mrc,
               ".nrrd": medical_io.load_nrrd}
    return next((readers[ext] for ext in extensions if name.endswith(ext)), None)


class _PILImageReader:
    """Image file reader that probes shape and dtype through PIL without decoding; the
    pixels are decoded on first access, once, however many loader threads ask at the
    same time. A multi-page TIFF reads as (n_pages, H, W[, C]). A pickled reader (sent to
    a worker process) leaves its pixels behind and decodes them again there."""

    def __init__(self, path: str):
        self.path = path
        self._data = None
        self._lock = threading.Lock()
        self.shape, self.dtype = self._probe()

    def __getstate__(self):
        return {"path": self.path, "_data": None, "shape": self.shape, "dtype": self.dtype}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

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
            with self._lock:
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
    medical = _medical_reader(image_path, (".nii", ".nii.gz", ".mha", ".mhd"))
    if medical is not None:
        return medical(image_path)
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
    """Open an HDF5 file, returning its root group (``utils/hdf5.File``)."""
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
    if ext in ZARR_EXTENSIONS or ext in N5_EXTENSIONS:
        return LazyTensorStore(path, key, mode)
    if ext in IMAGE_EXTENSIONS:
        if key is not None:
            raise ValueError(f"Expected key=None for image file {path}, got {key}.")
        return _lazy_image(path)
    medical = _medical_reader(path, MEDICAL_EXTENSIONS)
    if medical is not None:
        return medical(path)
    raise ValueError(f"Unsupported data format: {ext} ({path}).")


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
    """Write an array into an HDF5 container (gzip, replacing ``key``), a zarr or N5 container
    (replacing ``key``; N5's ``dimensions`` and ``blockSize`` column-major), a ``.npy`` file or
    an image file (PIL; see ``_write_image``)."""
    ext = _extension(path)
    if ext in HDF5_EXTENSIONS:
        with _h5py().File(path, "a") as f:
            if key in f:
                del f[key]
            f.create_dataset(key, data=data, chunks=chunks, compression="gzip")
        return
    if ext in ZARR_EXTENSIONS or ext in N5_EXTENSIONS:
        data = np.asarray(data)
        fmt = "zarr" if ext in ZARR_EXTENSIONS else "n5"
        zarr_n5.create_array(path, key, data.shape, data.dtype, chunks, fmt)[...] = data
        return
    if ext in NUMPY_EXTENSIONS:
        np.save(path, data)
        return
    if ext in IMAGE_EXTENSIONS:
        _write_image(path, data)
        return
    if str(path).lower().endswith(MEDICAL_EXTENSIONS):
        raise NotImplementedError(
            f"write_data does not write {ext} data ({path}), as in the JAX package: use the writers of "
            "utils/medical_io.py (save_nifti, save_mha, save_mrc, save_nrrd)."
        )
    raise ValueError(f"Unsupported output format: {ext} ({path}).")


# the PIL modes that each image format stores and reads back as they were written (JPEG: through its lossy codec)
IMAGE_MODES = {".png": ("1", "L", "I;16", "RGB", "RGBA"), ".tif": ("1", "L", "I;16", "I", "F", "RGB", "RGBA"),
               ".tiff": ("1", "L", "I;16", "I", "F", "RGB", "RGBA"), ".bmp": ("1", "L", "RGB"),
               ".jpg": ("L", "RGB"), ".jpeg": ("L", "RGB")}
_GREY_MODES = {np.dtype(bool): "1", np.dtype(np.uint8): "L", np.dtype(np.uint16): "I;16", np.dtype(np.int32): "I",
               np.dtype(np.float32): "F"}


def _image_mode(dtype: np.dtype, shape: Tuple[int, ...]) -> Optional[str]:
    """The PIL mode of one image (page) of ``dtype`` and ``shape``, or None."""
    if len(shape) == 2:
        return _GREY_MODES.get(dtype)
    if len(shape) == 3 and dtype == np.uint8 and shape[-1] in (3, 4):
        return "RGB" if shape[-1] == 3 else "RGBA"
    return None


def _write_image(path: Union[str, os.PathLike], data: np.ndarray) -> None:
    """Write an image file through PIL: a 2-D ``bool``, ``uint8``, ``uint16``, ``int32`` or ``float32`` image,
    an (H, W, 3) or (H, W, 4) ``uint8`` RGB or RGBA image, or (TIFF only) a stack of either along the first axis
    as a multi-page TIFF, which ``load_image`` reads back as the same array. A dtype, shape or format that PIL
    does not store as written raises ``ValueError`` naming it (``IMAGE_MODES``)."""
    ext = _extension(path)
    data = np.asarray(data)
    if ext not in IMAGE_MODES:
        raise ValueError(f"write_image writes {', '.join(IMAGE_MODES)}, not {ext} ({path})")
    mode = _image_mode(data.dtype, data.shape)
    pages = [data]
    if mode is None and data.ndim >= 3:
        mode = _image_mode(data.dtype, data.shape[1:])
        pages = list(data)
        if mode is not None and ext not in (".tif", ".tiff"):
            raise ValueError(f"a stack of {data.shape[0]} images {data.shape[1:]} ({data.dtype}) is written as a "
                             f"multi-page TIFF, not as {ext} ({path})")
    if mode is None or mode not in IMAGE_MODES[ext]:
        raise ValueError(f"PIL does not write an image of dtype {data.dtype} and shape {data.shape} as {ext} "
                         f"({path}); {ext} stores the modes {', '.join(IMAGE_MODES[ext])}")
    Image = _pil_image()
    images = [Image.fromarray(np.ascontiguousarray(page)) for page in pages]
    if len(images) == 1:
        images[0].save(path)
    else:
        images[0].save(path, save_all=True, append_images=images[1:])


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
