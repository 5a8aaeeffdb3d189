"""zarr v2 and N5 arrays, read and written by the port's own code: numpy, the standard library
(``json``, ``zlib``, ``gzip``, ``bz2``, ``lzma``) and the blosc codec of ``ops/native/blosc.cpp``;
never tensorstore or zarr-python.

An array is a folder: zarr keeps its metadata in ``.zarray`` and each chunk in a file named by
its grid index (``0.1.2``, or ``0/1/2`` with ``dimension_separator`` "/"); N5 keeps it in
``attributes.json`` with ``dimensions`` and ``blockSize`` column-major (x first) and each block
under ``x/y/z``, big-endian, behind a header of its mode, rank and size. ``ChunkedArray`` reads
and writes both through C order, so an N5 array of ``dimensions`` (x, y, z) reads as (z, y, x),
as ``utils/io.py`` always did. A key is a slash path inside the container, which may or may not
hold a ``.zgroup`` or a root ``attributes.json``.

Read: zarr dtypes with byte order (``|b1``, ``|u1``, ``>u2``, ...), ``order`` C or F,
``fill_value`` (a number, ``"NaN"``, ``"Infinity"``, null for zero) for missing chunks, and the
compressors null, blosc (lz4, lz4hc, blosclz, zlib), zlib, gzip and bz2; N5 ``dataType``,
``compression`` raw, gzip (``useZlib`` too), bzip2, xz and blosc, block modes 0 and 1, truncated
edge blocks, missing blocks as zero. zstd and snappy, non-null zarr ``filters``, zarr v3 and N5
object blocks (mode 2) raise ``NotImplementedError`` naming what is not read.

Written: ``create_array`` writes the metadata that tensorstore writes for an array created with
only a shape, a dtype and maybe chunks (blosc lz4 at clevel 5; zarr ``shuffle`` -1, N5 bit shuffle
for 1-byte types and byte shuffle otherwise; ``default_chunks`` where none are given), replacing
the key; ``ChunkedArray.__setitem__`` writes a window, reading, modifying and writing back the
chunks it covers in part. Edge chunks are stored at full size. As tensorstore does, every zarr
chunk is written (``fill_value`` null) and an N5 block that is all zero is not.
"""

import bz2
import gzip
import itertools
import json
import lzma
import math
import os
import shutil
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops.native import blosc

__all__ = ["ChunkedArray", "create_array", "default_chunks", "FORMATS"]

FORMATS = ("zarr", "n5")
DEFAULT_CHUNK_ELEMENTS = 1 << 20
N5_DTYPES = ("uint8", "uint16", "uint32", "uint64", "int8", "int16", "int32", "int64", "float32", "float64")
BLOSC_LZ4 = {"blocksize": 0, "clevel": 5, "cname": "lz4"}
THREADS = min(8, os.cpu_count() or 1)  # decode or encode the chunks of one window at once
_POOL = {"pid": None, "pool": None}
_POOL_LOCK = threading.Lock()


def _each(fn, items):
    """``fn`` over ``items``, on the module's thread pool (one per process) where there is more than one; ctypes
    and zlib release the GIL, so the chunks' codecs run at once."""
    items = list(items)
    if len(items) < 2 or THREADS < 2:
        return [fn(item) for item in items]
    with _POOL_LOCK:
        if _POOL["pid"] != os.getpid():
            _POOL.update(pid=os.getpid(), pool=ThreadPoolExecutor(THREADS, thread_name_prefix="zarr_n5"))
        pool = _POOL["pool"]
    return list(pool.map(fn, items))


def default_chunks(shape: Sequence[int]) -> Tuple[int, ...]:
    """tensorstore's chunk shape for an array created without one: every axis ``min(k, n)`` for the
    largest ``k`` whose chunk holds at most 2**20 elements."""
    shape = [int(n) for n in shape]

    def elements(k):
        return math.prod(max(1, min(k, n)) for n in shape)

    low, high = 1, max(shape + [1])
    while low < high:
        mid = (low + high + 1) // 2
        if elements(mid) <= DEFAULT_CHUNK_ELEMENTS:
            low = mid
        else:
            high = mid - 1
    return tuple(max(1, min(low, n)) for n in shape)


def _folder(path, key: Optional[str]) -> str:
    key = (key or "").strip("/")
    return os.path.join(str(path), *key.split("/")) if key else str(path)


def _json(meta: dict) -> str:
    return json.dumps(meta, sort_keys=True, separators=(",", ":"))


def _fill_value(value, dtype: np.dtype):
    if value is None:
        return np.zeros((), dtype)[()]
    if isinstance(value, str):
        named = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in named:
            raise NotImplementedError(f"the zarr fill_value {value!r} is not read by the port")
        value = named[value]
    return np.asarray(value).astype(dtype)[()]


class _Layout:
    """The parsed metadata of one array: shapes in C order, the dtype on disk and in memory, the codec."""

    def __init__(self, fmt, shape, chunks, disk_dtype, codec, order="C", fill=None, separator=".", keep_fill=True):
        self.fmt, self.shape, self.chunks = fmt, tuple(shape), tuple(chunks)
        self.disk_dtype = disk_dtype
        self.dtype = disk_dtype.newbyteorder("=") if disk_dtype.byteorder not in "|=" else disk_dtype
        self.codec, self.order, self.separator = codec, order, separator
        self.fill = _fill_value(fill, self.dtype)
        # zarr with fill_value null stores every chunk; N5 and zarr with a fill value leave out all-fill ones
        self.keep_fill = keep_fill

    @classmethod
    def read(cls, folder: str) -> "_Layout":
        zarray, attributes = os.path.join(folder, ".zarray"), os.path.join(folder, "attributes.json")
        if os.path.isfile(zarray):
            with open(zarray) as f:
                return cls._zarr(json.load(f), folder)
        if os.path.isfile(attributes):
            with open(attributes) as f:
                meta = json.load(f)
            if "dimensions" in meta:
                return cls._n5(meta, folder)
        if os.path.isfile(os.path.join(folder, "zarr.json")):
            raise NotImplementedError(f"zarr v3 arrays are not read by the port ({folder})")
        raise FileNotFoundError(f"no zarr or N5 array at {folder}")

    @classmethod
    def _zarr(cls, meta: dict, folder: str) -> "_Layout":
        if meta.get("zarr_format", 2) != 2:
            raise NotImplementedError(f"zarr format {meta.get('zarr_format')} is not read by the port ({folder})")
        if meta.get("filters"):
            names = [f.get("id") for f in meta["filters"]]
            raise NotImplementedError(f"zarr filters {names} are not read by the port ({folder})")
        if not isinstance(meta["dtype"], str):
            raise NotImplementedError(f"the structured zarr dtype {meta['dtype']} is not read by the port ({folder})")
        dtype = np.dtype(meta["dtype"])
        codec = meta.get("compressor")
        _check_codec("zarr", codec)
        return cls("zarr", meta["shape"], meta["chunks"], dtype, codec, order=meta.get("order", "C"),
                   fill=meta.get("fill_value"), separator=meta.get("dimension_separator", "."),
                   keep_fill=meta.get("fill_value") is None)

    @classmethod
    def _n5(cls, meta: dict, folder: str) -> "_Layout":
        codec = meta.get("compression", {"type": meta.get("compressionType", "raw")})
        _check_codec("n5", codec)
        if meta["dataType"] not in N5_DTYPES:
            raise NotImplementedError(f"the N5 dataType {meta['dataType']} is not read by the port ({folder})")
        return cls("n5", meta["dimensions"][::-1], meta["blockSize"][::-1], np.dtype(meta["dataType"]).newbyteorder(">"),
                   codec, keep_fill=False)

    def chunk_file(self, folder: str, index: Tuple[int, ...]) -> str:
        if self.fmt == "n5":
            return os.path.join(folder, *(str(i) for i in index[::-1]))
        if not index:
            return os.path.join(folder, "0")
        if self.separator == "/":
            return os.path.join(folder, *(str(i) for i in index))
        return os.path.join(folder, ".".join(str(i) for i in index))

    def decode(self, data: bytes) -> np.ndarray:
        """A chunk file's array, in C order (an N5 block with the shape its header gives)."""
        if self.fmt == "zarr":
            shape, raw = self.chunks, _decompress(self.codec, "zarr", data)
        else:
            shape, offset = _n5_header(data, len(self.shape))
            raw = _decompress(self.codec, "n5", memoryview(data)[offset:])
        count = math.prod(shape)
        flat = np.frombuffer(raw, dtype=self.disk_dtype, count=count)
        return flat.reshape(shape, order="F" if self.order == "F" else "C")

    def encode(self, block: np.ndarray) -> bytes:
        """The chunk file of a full-size chunk in C order."""
        raw = np.asarray(block, dtype=self.disk_dtype)
        if self.fmt == "zarr":
            return _compress(self.codec, "zarr", np.asfortranarray(raw).T if self.order == "F" else raw)
        header = struct.pack(f">HH{raw.ndim}I", 0, raw.ndim, *raw.shape[::-1])
        return header + _compress(self.codec, "n5", raw)


def _n5_header(data: bytes, ndim: int) -> Tuple[Tuple[int, ...], int]:
    """An N5 block's shape in C order and the offset of its data, from its header."""
    mode, rank = struct.unpack_from(">HH", data)
    if mode == 2:
        raise NotImplementedError("N5 object blocks (mode 2) are not read by the port")
    if mode not in (0, 1):
        raise ValueError(f"N5 block of unknown mode {mode}")
    if rank != ndim:
        raise ValueError(f"N5 block of rank {rank} in an array of rank {ndim}")
    dims = struct.unpack_from(f">{rank}I", data, 4)
    offset = 4 + 4 * rank
    if mode == 1:
        (count,) = struct.unpack_from(">I", data, offset)
        offset += 4
        if count != math.prod(dims):
            raise NotImplementedError(f"N5 varlength blocks of {count} elements in a block of {dims} are not read "
                                      "by the port")
    return tuple(dims[::-1]), offset


_UNREAD_BLOSC = ("zstd", "snappy")


def _codec_name(codec: Optional[dict], fmt: str) -> str:
    if codec is None:
        return "raw"
    return codec.get("id" if fmt == "zarr" else "type")


def _check_codec(fmt: str, codec: Optional[dict]):
    name = _codec_name(codec, fmt)
    known = ("raw", "blosc", "zlib", "gzip", "bz2") if fmt == "zarr" else ("raw", "blosc", "gzip", "bzip2", "xz")
    if name not in known:
        raise NotImplementedError(f"the {fmt} compressor {name} is not read by the port")
    if name == "blosc" and codec.get("cname") in _UNREAD_BLOSC:
        raise NotImplementedError(f"blosc with the codec {codec['cname']} is not read by the port")


def _decompress(codec: Optional[dict], fmt: str, data) -> bytes:
    name = _codec_name(codec, fmt)
    if name == "raw":
        return data
    if name == "blosc":
        return blosc.decompress(data)
    if name == "zlib" or (name == "gzip" and codec.get("useZlib")):
        return zlib.decompress(data)
    if name == "gzip":
        return gzip.decompress(data)
    if name in ("bz2", "bzip2"):
        return bz2.decompress(data)
    return lzma.decompress(data)


def _blosc_shuffle(codec: dict, itemsize: int) -> str:
    shuffle = codec.get("shuffle", -1)
    if shuffle == -1:
        return "bit" if itemsize == 1 else "byte"
    return ("none", "byte", "bit")[shuffle]


def _compress(codec: Optional[dict], fmt: str, raw: np.ndarray) -> bytes:
    name = _codec_name(codec, fmt)
    if name == "raw":
        return raw.tobytes()
    if name == "blosc":
        if codec.get("cname", "lz4") not in ("lz4", "lz4hc"):
            raise NotImplementedError(f"the port writes blosc chunks with lz4 only, not {codec['cname']}")
        return blosc.compress(raw, raw.dtype.itemsize, _blosc_shuffle(codec, raw.dtype.itemsize),
                              codec.get("clevel", 5))
    level = codec.get("level", -1)
    if name == "zlib" or (name == "gzip" and codec.get("useZlib")):
        return zlib.compress(raw.tobytes(), level)
    if name == "gzip":
        return gzip.compress(raw.tobytes(), 9 if level < 0 else level, mtime=0)
    if name in ("bz2", "bzip2"):
        return bz2.compress(raw.tobytes(), codec.get("blockSize", 9) if level < 0 else level)
    return lzma.compress(raw.tobytes(), preset=codec.get("preset", 6))


def _window(index, shape):
    """``index`` (ints, slices, one Ellipsis) as the box [starts, stops) it reads, and the index that takes
    the selection out of the box (0 for an int's axis, a slice for a strided one)."""
    if not isinstance(index, tuple):
        index = (index,)
    if sum(ix is Ellipsis for ix in index) > 1:
        raise IndexError("an index can only have a single ellipsis")
    if Ellipsis in index:
        at = index.index(Ellipsis)
        index = index[:at] + (slice(None),) * (len(shape) - len(index) + 1) + index[at + 1:]
    if len(index) > len(shape):
        raise IndexError(f"too many indices ({len(index)}) for an array of rank {len(shape)}")
    index = index + (slice(None),) * (len(shape) - len(index))
    starts, stops, post = [], [], []
    for ix, n in zip(index, shape):
        if isinstance(ix, (int, np.integer)):
            i = int(ix) + (n if ix < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {int(ix)} is out of bounds for an axis of size {n}")
            starts.append(i), stops.append(i + 1), post.append(0)
        elif isinstance(ix, slice):
            picked = range(*ix.indices(n))
            if len(picked) == 0:
                starts.append(0), stops.append(0), post.append(slice(None))
            elif picked.step == 1:
                starts.append(picked.start), stops.append(picked.stop), post.append(slice(None))
            else:
                low, high = min(picked[0], picked[-1]), max(picked[0], picked[-1]) + 1
                end = picked[-1] - low + (1 if picked.step > 0 else -1)
                starts.append(low), stops.append(high)
                post.append(slice(picked[0] - low, None if end < 0 else end, picked.step))
        else:
            raise TypeError(f"zarr and N5 arrays take ints, slices and Ellipsis, not {type(ix).__name__}")
    return starts, stops, tuple(post)


class ChunkedArray:
    """A zarr v2 or N5 array on disk: ``shape``, ``dtype``, ``ndim``, ``chunks``, ``__len__`` and
    ``__getitem__`` with ints, slices and Ellipsis, which reads and decodes only the chunks that the
    window touches (threads may read at once). ``__setitem__`` writes a window unless the array was
    opened with ``mode`` "r". It pickles as (path, key, mode) and opens again where it is unpickled."""

    def __init__(self, path, key: Optional[str] = None, mode: str = "r"):
        self.path, self.key, self.mode = str(path), key, mode
        self._folder = _folder(path, key)
        self._layout = _Layout.read(self._folder)
        self.shape, self.chunks, self.dtype = self._layout.shape, self._layout.chunks, self._layout.dtype
        self.format = self._layout.fmt
        self._made = set()  # chunk folders this handle has made

    def __reduce__(self):
        return (type(self), (self.path, self.key, self.mode))

    @property
    def ndim(self):
        return len(self.shape)

    def __len__(self):
        return self.shape[0]

    def _grid(self, starts, stops):
        return itertools.product(*(range(a // c, -(-b // c)) if b > a else range(0)
                                   for a, b, c in zip(starts, stops, self.chunks)))

    def _read_chunk(self, index) -> Optional[np.ndarray]:
        """The chunk at grid ``index`` at full chunk size (a truncated N5 edge block padded with the fill), or
        None where its file is missing."""
        try:
            with open(self._layout.chunk_file(self._folder, index), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return None
        block = self._layout.decode(data)
        if block.shape == self.chunks:
            return block
        if any(b > c for b, c in zip(block.shape, self.chunks)):
            raise ValueError(f"a block of {block.shape} in {self.path} ({self.key}), whose chunks are {self.chunks}")
        full = np.full(self.chunks, self._layout.fill, dtype=block.dtype)
        full[tuple(slice(0, b) for b in block.shape)] = block
        return full

    def __getitem__(self, index) -> np.ndarray:
        starts, stops, post = _window(index, self.shape)
        out = np.empty([b - a for a, b in zip(starts, stops)], dtype=self.dtype)

        def place(chunk_index):
            src, dst = [], []
            for a, b, i, c in zip(starts, stops, chunk_index, self.chunks):
                low, high = max(a, i * c), min(b, (i + 1) * c)
                src.append(slice(low - i * c, high - i * c))
                dst.append(slice(low - a, high - a))
            block = self._read_chunk(chunk_index)
            out[tuple(dst)] = self._layout.fill if block is None else block[tuple(src)]

        _each(place, self._grid(starts, stops))
        return out[post]

    def __setitem__(self, index, value):
        if self.mode == "r":
            raise PermissionError(f"{self.path} ({self.key}) was opened read-only (mode 'r')")
        starts, stops, post = _window(index, self.shape)
        if any(isinstance(p, slice) and p != slice(None) for p in post):
            raise IndexError("zarr and N5 arrays are written through windows of step 1")
        box = [b - a for a, b in zip(starts, stops)]
        value = np.broadcast_to(np.asarray(value, dtype=self.dtype),
                                [n for n, p in zip(box, post) if p != 0] if post else box).reshape(box)
        _each(lambda c: self._write_window(c, starts, stops, value), self._grid(starts, stops))

    def _write_window(self, chunk_index, starts, stops, value):
        src, dst, covered = [], [], True
        for a, b, i, c, n in zip(starts, stops, chunk_index, self.chunks, self.shape):
            low, high = max(a, i * c), min(b, (i + 1) * c)
            src.append(slice(low - a, high - a))
            dst.append(slice(low - i * c, high - i * c))
            covered &= low == i * c and high == min(n, (i + 1) * c)
        part = value[tuple(src)]
        if covered and part.shape == self.chunks:
            block = part
        else:
            # an edge chunk is stored at full size, the fill beyond the array; a chunk written in part keeps the rest
            old = None if covered else self._read_chunk(chunk_index)
            block = np.full(self.chunks, self._layout.fill, dtype=self.dtype) if old is None else old.astype(self.dtype)
            block[tuple(dst)] = part
        self._store(chunk_index, block)

    def _store(self, chunk_index, block):
        target = self._layout.chunk_file(self._folder, chunk_index)
        if not self._layout.keep_fill and (block == self._layout.fill).all():
            if os.path.exists(target):
                os.remove(target)
            return
        data = self._layout.encode(block)
        parent = os.path.dirname(target)
        if parent not in self._made:
            os.makedirs(parent, exist_ok=True)
            self._made.add(parent)
        # written under another name and renamed, so a reader never sees half a chunk
        tmp = f"{target}.{os.getpid()}-{threading.get_ident()}.part"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, target)


def create_array(path, key: Optional[str], shape: Sequence[int], dtype, chunks: Optional[Sequence[int]] = None,
                 fmt: str = "zarr") -> ChunkedArray:
    """Create the array ``key`` of a zarr or N5 container (``fmt``), replacing whatever the key held, with the
    metadata tensorstore writes (blosc lz4, ``default_chunks`` where ``chunks`` is None); returns it open for
    writing. No chunk is written yet."""
    if fmt not in FORMATS:
        raise ValueError(f"fmt must be one of {FORMATS}, got {fmt!r}")
    dtype = np.dtype(dtype)
    shape = [int(n) for n in shape]
    chunks = list(default_chunks(shape) if chunks is None else (int(c) for c in chunks))
    if len(chunks) != len(shape) or min(chunks, default=1) < 1:
        raise ValueError(f"chunks {chunks} do not fit the shape {shape}")
    if fmt == "zarr":
        if dtype.kind not in "biufc":
            raise ValueError(f"zarr arrays of dtype {dtype} are not written by the port")
        little = dtype.newbyteorder("<") if dtype.itemsize > 1 else dtype
        name, meta = ".zarray", {"chunks": chunks, "compressor": dict(BLOSC_LZ4, id="blosc", shuffle=-1),
                                 "dimension_separator": ".", "dtype": little.str, "fill_value": None,
                                 "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
    else:
        if dtype.name not in N5_DTYPES:
            raise ValueError(f"N5 has no data type {dtype}; it stores {', '.join(N5_DTYPES)}")
        name, meta = "attributes.json", {
            "blockSize": chunks[::-1], "compression": dict(BLOSC_LZ4, shuffle=2 if dtype.itemsize == 1 else 1,
                                                           type="blosc"),
            "dataType": dtype.name, "dimensions": shape[::-1]}
    folder = _folder(path, key)
    if os.path.isdir(folder):
        shutil.rmtree(folder)
    os.makedirs(folder)
    with open(os.path.join(folder, name), "w") as f:
        f.write(_json(meta))
    return ChunkedArray(path, key, mode="a")
