"""The port's own HDF5: reads and writes HDF5 files in numpy and zlib, with no h5py.

``File``, ``Group``, ``Dataset`` and ``AttributeManager`` are the subset of h5py's API that
the port uses: files opened in the modes ``r``, ``r+``, ``w``, ``w-``/``x`` and ``a``;
groups addressed by paths (``f["a/b"]``), created, listed and deleted; datasets with
``shape``, ``dtype``, ``chunks``, ``maxshape``, ``compression`` and ``attrs``, read and
written by integers, slices (step >= 1) and ``Ellipsis``, and grown by ``resize``;
attributes of numbers, arrays, ``str`` and ``bytes``.

What it reads: everything h5py writes with its default ``libver`` ("earliest"): superblocks
v0 and v1, object headers v1 with continuation blocks, symbol-table groups (a v1 B-tree of
symbol-table nodes over a local heap), compact, contiguous and chunked layouts with the v1
B-tree chunk index; and of what h5py writes with ``libver="latest"``, superblocks v2 and v3,
object headers v2, compact groups of link messages, and layout v4 with the single-chunk,
implicit and fixed-array chunk indexes; every checksum is verified. Dense groups and dense
attributes (fractal heap) and the extensible-array and v2 B-tree chunk indexes raise
``NotImplementedError`` naming the structure.

What it writes: the earliest format (superblock v0, object headers v1, symbol-table groups,
a contiguous layout where there is no chunking, filter or ``maxshape``, else chunks under a
v1 B-tree), also into a file of that format that h5py wrote. New objects go to the end of
the file; a group's B-tree and a dataset's chunk B-tree are written afresh on change, with
the root node kept at its address, so the object headers that point at them stay valid, and
the space they held is left unused, as HDF5 itself does. Writing into a file of the latest
format raises ``NotImplementedError``.

Filters: deflate (zlib, level 4 by default, as h5py), shuffle, fletcher32 (checked on read)
and LZF (``ops/native/lzf.cpp``, built with g++ at first use). Other filters raise
``NotImplementedError`` naming them. Types: little- and big-endian integers of 8-64 bits,
float16/32/64, h5py's bool (an int8 enum), fixed- and variable-length strings; other classes
raise ``NotImplementedError`` naming the HDF5 class.

For data loaders: reads go through ``os.pread`` (no shared file position), so threads can
share a handle; a chunked dataset builds its chunk index once, under a lock, and a selection
decodes only the chunks it touches; in mode ``r`` unfiltered data is read through a memory
map, so a window reads only its own pages. A ``File``, ``Group`` or ``Dataset`` pickles as
its path, name and mode and opens the file again when unpickled.
"""

import collections.abc
import errno
import itertools
import os
import struct
import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["File", "Group", "Dataset", "AttributeManager", "guess_chunk"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"
FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset",
                32000: "lzf", 32001: "blosc", 32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}
CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string", 4: "bitfield", 5: "opaque",
               6: "compound", 7: "reference", 8: "enumerated", 9: "variable-length", 10: "array"}
DEFAULT_GZIP = 4
# h5py's chunk guess (h5py/_hl/filters.py)
CHUNK_BASE, CHUNK_MIN, CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024
# message types of an object header
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL, LINK, EXTERNAL, LAYOUT = 0, 1, 2, 3, 4, 5, 6, 7, 8
FILTERS, ATTRIBUTE, CONTINUATION, SYMBOL_TABLE, ATTRIBUTE_INFO = 0xB, 0xC, 0x10, 0x11, 0x15
GROUP_INFO = 0xA
H5HL_FREE_NULL = 1  # end of a local heap's free list
OPTIONAL_FILTER = 1


# ---------------------------------------------------------------------------------------------
# checksums


def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``, the checksum of HDF5's newer metadata."""
    m = 0xFFFFFFFF
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & m
    i = 0
    while n - i > 12:
        x, y, z = struct.unpack_from("<III", data, i)
        a, b, c = (a + x) & m, (b + y) & m, (c + z) & m
        a = (a - c) & m; a ^= _rot(c, 4); c = (c + b) & m
        b = (b - a) & m; b ^= _rot(a, 6); a = (a + c) & m
        c = (c - b) & m; c ^= _rot(b, 8); b = (b + a) & m
        a = (a - c) & m; a ^= _rot(c, 16); c = (c + b) & m
        b = (b - a) & m; b ^= _rot(a, 19); a = (a + c) & m
        c = (c - b) & m; c ^= _rot(b, 4); b = (b + a) & m
        i += 12
    if n - i == 0:
        return c
    x, y, z = struct.unpack("<III", bytes(data[i:]) + b"\0" * (12 - (n - i)))
    a, b, c = (a + x) & m, (b + y) & m, (c + z) & m
    c ^= b; c = (c - _rot(b, 14)) & m
    a ^= c; a = (a - _rot(c, 11)) & m
    b ^= a; b = (b - _rot(a, 25)) & m
    c ^= b; c = (c - _rot(b, 16)) & m
    a ^= c; a = (a - _rot(c, 4)) & m
    b ^= a; b = (b - _rot(a, 14)) & m
    c ^= b; c = (c - _rot(b, 24)) & m
    return c


def _check(data: bytes, what: str) -> bytes:
    """``data`` without its trailing lookup3 checksum, which must match."""
    stored = int.from_bytes(data[-4:], "little")
    if lookup3(data[:-4]) != stored:
        raise OSError(f"HDF5 {what}: checksum mismatch")
    return data[:-4]


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (``H5_checksum_fletcher32``): 16-bit big-endian words, folded every
    360 words."""
    buf = np.frombuffer(data, dtype=np.uint8)
    odd = len(buf) % 2
    words = buf[: len(buf) - odd].view(">u2").astype(np.int64)
    sum1 = sum2 = 0
    for start in range(0, len(words), 360):
        block = words[start:start + 360]
        t = len(block)
        sum2 += t * sum1 + int(np.dot(block, np.arange(t, 0, -1, dtype=np.int64)))
        sum1 += int(block.sum())
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if odd:
        sum1 += int(buf[-1]) << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return ((sum2 << 16) | sum1) & 0xFFFFFFFF


# ---------------------------------------------------------------------------------------------
# decoding helpers


class _Cursor:
    """Little-endian reader over a bytes object, with the file's sizes of offsets and lengths."""

    __slots__ = ("data", "pos", "osz", "lsz")

    def __init__(self, data, pos: int = 0, osz: int = 8, lsz: int = 8):
        self.data, self.pos, self.osz, self.lsz = data, pos, osz, lsz

    def u(self, n: int) -> int:
        v = int.from_bytes(self.data[self.pos:self.pos + n], "little")
        self.pos += n
        return v

    def addr(self) -> Optional[int]:
        v = self.u(self.osz)
        return None if v == (1 << (8 * self.osz)) - 1 else v

    def length(self) -> int:
        return self.u(self.lsz)

    def take(self, n: int) -> bytes:
        v = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return v

    def cstring(self) -> bytes:
        end = self.data.index(b"\0", self.pos)
        v = bytes(self.data[self.pos:end])
        self.pos = end + 1
        return v


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _u(value: int, n: int) -> bytes:
    return int(value).to_bytes(n, "little")


UNDEF = 0xFFFFFFFFFFFFFFFF


def _addr(value: Optional[int]) -> bytes:
    return _u(UNDEF if value is None else value, 8)


# ---------------------------------------------------------------------------------------------
# datatypes


class _Type:
    """A decoded datatype: ``dtype`` is the numpy type of its stored bytes; ``kind`` is
    "numeric", "bool", "vlen_str", "str" (fixed, UTF-8) or "bytes" (fixed, ASCII)."""

    __slots__ = ("dtype", "kind", "size")

    def __init__(self, dtype, kind: str, size: int):
        self.dtype, self.kind, self.size = np.dtype(dtype), kind, size


def _decode_datatype(cur: _Cursor) -> _Type:
    start = cur.pos
    head = cur.u(1)
    cls, version = head & 0x0F, head >> 4
    bits = cur.u(3)
    size = cur.u(4)
    if cls == 0:  # fixed-point
        cur.u(2), cur.u(2)
        order = ">" if bits & 1 else "<"
        if size not in (1, 2, 4, 8):
            raise NotImplementedError(f"HDF5 fixed-point type of {size} bytes")
        return _Type(f"{order}{'i' if bits & 8 else 'u'}{size}", "numeric", size)
    if cls == 1:  # floating-point
        cur.pos += 12
        order = ">" if bits & 1 else "<"
        if bits & 0x40 or size not in (2, 4, 8):
            raise NotImplementedError(f"HDF5 floating-point type of {size} bytes (byte order bits {bits & 0x41})")
        return _Type(f"{order}f{size}", "numeric", size)
    if cls == 3:  # fixed-length string
        return _Type(f"S{size}", "str" if (bits >> 4) & 0x0F == 1 else "bytes", size)
    if cls == 8:  # enumeration: h5py's bool is an int8 enum of FALSE = 0, TRUE = 1
        n = bits & 0xFFFF
        base = _decode_datatype(cur)
        names = []
        for _ in range(n):
            name_start = cur.pos
            names.append(cur.cstring())
            if version < 3:
                cur.pos = name_start + _pad8(cur.pos - name_start)
        values = np.frombuffer(cur.take(n * base.size), dtype=base.dtype)
        members = dict(zip(names, values.tolist()))
        if base.size == 1 and members == {b"FALSE": 0, b"TRUE": 1}:
            return _Type(base.dtype, "bool", size)
        return _Type(base.dtype, "numeric", size)
    if cls == 9:  # variable length
        vtype = bits & 0x0F
        _decode_datatype(cur)
        if vtype != 1:
            raise NotImplementedError("HDF5 variable-length sequence type")
        return _Type(f"V{size}", "vlen_str", size)
    cur.pos = start
    raise NotImplementedError(f"HDF5 datatype class {cls} ({CLASS_NAMES.get(cls, 'unknown')})")


def _encode_datatype(dtype: np.dtype) -> bytes:
    """The datatype message of a numpy dtype (numbers, bool and fixed-length bytes)."""
    dtype = np.dtype(dtype)
    big = dtype.byteorder == ">" or (dtype.byteorder == "=" and not np.little_endian)
    if dtype.kind == "b":
        base = _encode_datatype(np.dtype("i1"))
        names = b"".join(name + b"\0" * (_pad8(len(name) + 1) - len(name)) for name in (b"FALSE", b"TRUE"))
        return bytes([0x18]) + _u(2, 3) + _u(1, 4) + base + names + bytes([0, 1])
    if dtype.kind in "iu":
        bits = (1 if big else 0) | (8 if dtype.kind == "i" else 0)
        return bytes([0x10]) + _u(bits, 3) + _u(dtype.itemsize, 4) + _u(0, 2) + _u(8 * dtype.itemsize, 2)
    if dtype.kind == "f":
        layout = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127), 8: (63, 52, 11, 0, 52, 1023)}
        if dtype.itemsize not in layout:
            raise NotImplementedError(f"writing the HDF5 floating-point type of {dtype}")
        sign, eloc, esize, mloc, msize, bias = layout[dtype.itemsize]
        bits = (1 if big else 0) | 0x20 | (sign << 8)
        return (bytes([0x11]) + _u(bits, 3) + _u(dtype.itemsize, 4) + _u(0, 2) + _u(8 * dtype.itemsize, 2)
                + bytes([eloc, esize, mloc, msize]) + _u(bias, 4))
    if dtype.kind == "S":
        return bytes([0x13]) + _u(1, 3) + _u(max(dtype.itemsize, 1), 4)  # null-padded ASCII
    raise NotImplementedError(f"writing the numpy type {dtype} to HDF5")


def _vlen_str_datatype() -> bytes:
    """A variable-length UTF-8 string (what h5py writes for a Python ``str``)."""
    base = bytes([0x10]) + _u(0, 3) + _u(1, 4) + _u(0, 2) + _u(8, 2)
    return bytes([0x19]) + _u(0x101, 3) + _u(16, 4) + base


# ---------------------------------------------------------------------------------------------
# dataspaces, layouts, filters


def _decode_dataspace(data) -> Tuple[Optional[Tuple[int, ...]], Optional[Tuple[Optional[int], ...]]]:
    """(shape, maxshape); a null dataspace gives (None, None)."""
    cur = _Cursor(data)
    version, rank, flags = cur.u(1), cur.u(1), cur.u(1)
    if version == 1:
        cur.u(5)
        kind = 1 if rank else 0
    elif version == 2:
        kind = cur.u(1)
    else:
        raise NotImplementedError(f"HDF5 dataspace message version {version}")
    if kind == 2:
        return None, None
    shape = tuple(cur.u(8) for _ in range(rank))
    if flags & 1:
        maxshape = tuple(None if v == UNDEF else v for v in (cur.u(8) for _ in range(rank)))
    else:
        maxshape = shape
    return shape, maxshape


def _encode_dataspace(shape, maxshape=None) -> bytes:
    flags = 1 if maxshape is not None and tuple(maxshape) != tuple(shape) else 0
    out = bytes([1, len(shape), flags, 0]) + b"\0" * 4 + b"".join(_u(s, 8) for s in shape)
    if flags:
        out += b"".join(_u(UNDEF if m is None else m, 8) for m in maxshape)
    return out


class _Filter:
    __slots__ = ("id", "flags", "values", "name")

    def __init__(self, fid: int, flags: int, values: Sequence[int], name: str = ""):
        self.id, self.flags, self.values, self.name = fid, flags, tuple(values), name


def _decode_filters(data) -> List[_Filter]:
    cur = _Cursor(data)
    version, n = cur.u(1), cur.u(1)
    if version == 1:
        cur.u(6)
    filters = []
    for _ in range(n):
        fid = cur.u(2)
        name_len = cur.u(2) if (version == 1 or fid >= 256) else 0
        flags, nvalues = cur.u(2), cur.u(2)
        name = cur.take(_pad8(name_len) if version == 1 else name_len).split(b"\0")[0].decode("ascii", "replace")
        values = [cur.u(4) for _ in range(nvalues)]
        if version == 1 and nvalues % 2:
            cur.u(4)
        filters.append(_Filter(fid, flags, values, name))
    return filters


def _encode_filters(filters: Sequence[_Filter]) -> bytes:
    out = bytes([1, len(filters)]) + b"\0" * 6
    for f in filters:
        name = f.name.encode() + b"\0"
        name += b"\0" * (_pad8(len(name)) - len(name))
        out += _u(f.id, 2) + _u(len(name), 2) + _u(f.flags, 2) + _u(len(f.values), 2) + name
        out += b"".join(_u(v, 4) for v in f.values)
        if len(f.values) % 2:
            out += b"\0" * 4
    return out


def _lzf():
    from ..ops.native import lzf

    return lzf


def _unfilter(raw: bytes, filters: Sequence[_Filter], mask: int, nbytes: int, itemsize: int) -> bytes:
    """Undo the filter pipeline on one chunk (skipping the filters set in ``mask``)."""
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        f = filters[i]
        if f.id == 1:
            raw = zlib.decompress(raw)
        elif f.id == 2:
            size = f.values[0] if f.values else itemsize
            raw = _unshuffle(raw, size)
        elif f.id == 3:
            stored = int.from_bytes(raw[-4:], "little")
            raw = raw[:-4]
            value = fletcher32(raw)
            swapped = ((value & 0x00FF00FF) << 8 | (value >> 8) & 0x00FF00FF) & 0xFFFFFFFF
            if stored not in (value, swapped):
                raise OSError("HDF5 fletcher32 checksum mismatch in a chunk")
        elif f.id == 32000:
            raw = _lzf().decompress(raw, nbytes)
        else:
            raise NotImplementedError(f"HDF5 filter {f.id} ({FILTER_NAMES.get(f.id, f.name or 'unknown')})")
    return raw


def _apply_filters(raw: bytes, filters: Sequence[_Filter], itemsize: int) -> Tuple[bytes, int]:
    """(filtered bytes, filter mask) of one chunk; an optional LZF stage that would not shrink
    the chunk is skipped, as HDF5 skips an optional filter that fails."""
    mask = 0
    for i, f in enumerate(filters):
        if f.id == 1:
            raw = zlib.compress(raw, f.values[0] if f.values else DEFAULT_GZIP)
        elif f.id == 2:
            raw = _shuffle(raw, f.values[0] if f.values else itemsize)
        elif f.id == 3:
            raw = raw + _u(fletcher32(raw), 4)
        elif f.id == 32000:
            packed = _lzf().compress(raw)
            if packed is None:
                mask |= 1 << i
            else:
                raw = packed
        else:
            raise NotImplementedError(f"HDF5 filter {f.id} ({FILTER_NAMES.get(f.id, f.name or 'unknown')})")
    return raw, mask


def _shuffle(raw: bytes, size: int) -> bytes:
    if size <= 1:
        return raw
    buf = np.frombuffer(raw, dtype=np.uint8)
    n = len(buf) // size
    return buf[: n * size].reshape(n, size).T.tobytes() + buf[n * size:].tobytes()


def _unshuffle(raw: bytes, size: int) -> bytes:
    if size <= 1:
        return raw
    buf = np.frombuffer(raw, dtype=np.uint8)
    n = len(buf) // size
    return buf[: n * size].reshape(size, n).T.tobytes() + buf[n * size:].tobytes()


def guess_chunk(shape: Sequence[int], maxshape, typesize: int) -> Tuple[int, ...]:
    """h5py's chunk guess: halve the axes in turn until a chunk is near a target size that grows
    with the dataset, between 8 KiB and 1 MiB (an axis of length 0 counts as 1024)."""
    shape = tuple((x if x != 0 else 1024) for x in shape)
    ndims = len(shape)
    if ndims == 0:
        raise ValueError("Chunks not allowed for scalar datasets.")
    chunks = np.array(shape, dtype="=f8")
    dset_size = np.prod(chunks) * typesize
    target_size = CHUNK_BASE * (2 ** np.log10(dset_size / (1024.0 * 1024)))
    target_size = min(max(target_size, CHUNK_MIN), CHUNK_MAX)
    idx = 0
    while True:
        chunk_bytes = np.prod(chunks) * typesize
        if (chunk_bytes < target_size or abs(chunk_bytes - target_size) / target_size < 0.5) \
                and chunk_bytes < CHUNK_MAX:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % ndims] = np.ceil(chunks[idx % ndims] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


# ---------------------------------------------------------------------------------------------
# selections


def _normalize_index(index, shape) -> Tuple[List[Tuple[int, int, int]], List[bool]]:
    """Per axis (start, stop, step) and whether the axis is dropped (an integer index)."""
    if not isinstance(index, tuple):
        index = (index,)
    if any(i is Ellipsis for i in index):
        k = next(j for j, i in enumerate(index) if i is Ellipsis)
        rest = [i for i in index[k + 1:]]
        if any(i is Ellipsis for i in rest):
            raise IndexError("an index can only have a single ellipsis")
        index = index[:k] + (slice(None),) * (len(shape) - len(index) + 1) + tuple(rest)
    if len(index) > len(shape):
        raise IndexError(f"too many indices ({len(index)}) for a dataset of rank {len(shape)}")
    index = index + (slice(None),) * (len(shape) - len(index))
    ranges, dropped = [], []
    for ix, n in zip(index, shape):
        if isinstance(ix, (int, np.integer)):
            i = int(ix)
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise IndexError(f"index {int(ix)} is out of range for an axis of length {n}")
            ranges.append((i, i + 1, 1))
            dropped.append(True)
        elif isinstance(ix, slice):
            start, stop, step = ix.indices(n)
            if step < 1:
                raise ValueError("step must be >= 1 (got %d)" % step)
            stop = max(stop, start)
            ranges.append((start, stop, step))
            dropped.append(False)
        else:
            raise TypeError(f"the port's HDF5 datasets take integers, slices and Ellipsis, got {type(ix).__name__}")
    return ranges, dropped


def _count(start: int, stop: int, step: int) -> int:
    return max(0, -(-(stop - start) // step))


def _overlap(rng, c0: int, c1: int):
    """For the selection (start, stop, step) and the chunk span [c0, c1): (source slice in the
    chunk, target slice in the output), or None where no selected element falls in the chunk."""
    start, stop, step = rng
    lo = max(c0, start)
    k0 = -(-(lo - start) // step)
    k1 = _count(start, min(c1, stop), step)
    if k1 <= k0:
        return None
    first = start + k0 * step - c0
    return slice(first, first + (k1 - k0 - 1) * step + 1, step), slice(k0, k1)


# ---------------------------------------------------------------------------------------------
# object headers


class _Message:
    __slots__ = ("type", "flags", "data")

    def __init__(self, mtype: int, flags: int, data: bytes):
        self.type, self.flags, self.data = mtype, flags, bytes(data)


class _Header:
    """An object header: its messages (continuation and NIL messages left out), and for a v1
    header the size of its first chunk, which a rewrite keeps."""

    def __init__(self, addr: int, version: int, messages: List[_Message], chunk0_size: int = 0,
                 refcount: int = 1):
        self.addr, self.version, self.messages = addr, version, messages
        self.chunk0_size, self.refcount = chunk0_size, refcount

    def find(self, mtype: int) -> Optional[_Message]:
        return next((m for m in self.messages if m.type == mtype), None)

    def all(self, mtype: int) -> List[_Message]:
        return [m for m in self.messages if m.type == mtype]


# ---------------------------------------------------------------------------------------------
# the latest format's indexes and dense storage: extensible arrays, v2 B-trees, fractal heaps


def _log2(n: int) -> int:
    return int(n).bit_length() - 1


def _enc_size(n: int) -> int:
    """Bytes HDF5 takes to store counts up to ``n`` (``H5VM_limit_enc_size``)."""
    return _log2(n) // 8 + 1


def _block(store: "_Store", addr: int, size: int, signature: bytes, what: str) -> bytes:
    """The ``size`` bytes at ``addr`` (checksum last, verified and cut off), which start with ``signature``."""
    data = store.pread(addr, size)
    if data[:4] != signature:
        raise OSError(f"HDF5 {what} without its {signature.decode()} signature")
    return _check(data, what)


def _earray_elements(store: "_Store", addr: int) -> Tuple[int, List[bytes]]:
    """(element size, the raw elements 0 .. max index set - 1) of the extensible array at ``addr``;
    an element of a block never written is None."""
    head = _block(store, addr, 12 + 6 * 8 + 8 + 4, b"EAHD", "extensible-array header")
    esize, max_bits, idx_elmts, dblk_min, sblk_min_ptrs, page_bits = head[6:12]
    max_idx_set = int.from_bytes(head[44:52], "little")
    iblock_addr = int.from_bytes(head[60:68], "little")
    if iblock_addr == UNDEF or max_idx_set == 0:
        return esize, []
    nsblks = 1 + max_bits - _log2(dblk_min)
    info, start_dblk = [], 0
    for u in range(nsblks):
        ndblks, nelmts = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
        info.append((ndblks, nelmts, start_dblk))
        start_dblk += ndblks
    iblock_nsblks = 2 * _log2(sblk_min_ptrs)
    ndblk_addrs, nsblk_addrs = 2 * (sblk_min_ptrs - 1), nsblks - iblock_nsblks
    off_size = (max_bits + 7) // 8
    prefix = 4 + 1 + 1 + 8
    iblock = _block(store, iblock_addr, prefix + idx_elmts * esize + 8 * (ndblk_addrs + nsblk_addrs) + 4, b"EAIB",
                    "extensible-array index block")
    pos = prefix
    elements = [iblock[pos + i * esize:pos + (i + 1) * esize] for i in range(idx_elmts)]
    pos += idx_elmts * esize
    dblk_addrs = [int.from_bytes(iblock[pos + 8 * i:pos + 8 * i + 8], "little") for i in range(ndblk_addrs)]
    pos += 8 * ndblk_addrs
    sblk_addrs = [int.from_bytes(iblock[pos + 8 * i:pos + 8 * i + 8], "little") for i in range(nsblk_addrs)]

    def data_block(daddr, nelmts):
        if daddr == UNDEF:
            return [None] * nelmts
        if nelmts > (1 << page_bits):
            raise NotImplementedError("HDF5 paged extensible-array data blocks")
        block = _block(store, daddr, prefix + off_size + nelmts * esize + 4, b"EADB", "extensible-array data block")
        base = prefix + off_size
        return [block[base + i * esize:base + (i + 1) * esize] for i in range(nelmts)]

    for u, (ndblks, nelmts, first) in enumerate(info):
        if len(elements) >= max_idx_set:
            break
        if u < iblock_nsblks:
            addrs = dblk_addrs[first:first + ndblks]
        else:
            saddr = sblk_addrs[u - iblock_nsblks]
            if saddr == UNDEF:
                addrs = [UNDEF] * ndblks
            else:
                if nelmts > (1 << page_bits):
                    raise NotImplementedError("HDF5 paged extensible-array data blocks")
                sblock = _block(store, saddr, prefix + off_size + 8 * ndblks + 4, b"EASB",
                                "extensible-array super block")
                base = prefix + off_size
                addrs = [int.from_bytes(sblock[base + 8 * i:base + 8 * i + 8], "little") for i in range(ndblks)]
        for daddr in addrs:
            elements.extend(data_block(daddr, nelmts))
    return esize, elements[:max_idx_set]


def _btree2_records(store: "_Store", addr: int) -> Tuple[int, List[bytes]]:
    """(record type, every record in key order) of the v2 B-tree at ``addr``."""
    head = _block(store, addr, 38, b"BTHD", "v2 B-tree header")
    btype = head[5]
    node_size, rec_size, depth = struct.unpack_from("<IHH", head, 6)
    root = int.from_bytes(head[16:24], "little")
    root_nrec = int.from_bytes(head[24:26], "little")
    max_nrec = [(node_size - 10) // rec_size]
    nrec_size = _enc_size(max_nrec[0])
    cum_max, cum_size = [max_nrec[0]], [0]
    for d in range(1, depth + 1):
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        max_nrec.append((node_size - (10 + ptr)) // (rec_size + ptr))
        cum_max.append((max_nrec[d] + 1) * cum_max[d - 1] + max_nrec[d])
        cum_size.append(_enc_size(cum_max[d]))
    records: List[bytes] = []

    def visit(node: int, nrec: int, d: int):
        if d == 0:
            leaf = _block(store, node, 6 + nrec * rec_size + 4, b"BTLF", "v2 B-tree leaf")
            records.extend(leaf[6 + i * rec_size:6 + (i + 1) * rec_size] for i in range(nrec))
            return
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        inner = _block(store, node, 6 + nrec * rec_size + (nrec + 1) * ptr + 4, b"BTIN", "v2 B-tree internal node")
        base = 6 + nrec * rec_size
        for i in range(nrec + 1):
            p = base + i * ptr
            child = int.from_bytes(inner[p:p + 8], "little")
            visit(child, int.from_bytes(inner[p + 8:p + 8 + nrec_size], "little"), d - 1)
            if i < nrec:
                records.append(inner[6 + i * rec_size:6 + (i + 1) * rec_size])

    if root != UNDEF and root_nrec:
        visit(root, root_nrec, depth)
    return btype, records


class _FractalHeap:
    """Reads objects of a fractal heap by heap ID: managed objects in the root direct block or in
    the direct blocks of the root indirect block, and tiny objects kept in the ID itself."""

    def __init__(self, store: "_Store", addr: int):
        head = store.pread(addr, 146)
        if head[:4] != b"FRHP":
            raise OSError("HDF5 fractal heap header without its FRHP signature")
        self.store = store
        self.id_len, filter_len = struct.unpack_from("<HH", head, 5)
        if filter_len:
            raise NotImplementedError("HDF5 fractal heap with I/O filters")
        _check(head[:146], "fractal heap header")
        max_man = int.from_bytes(head[10:14], "little")
        self.width = int.from_bytes(head[110:112], "little")
        self.start = int.from_bytes(head[112:120], "little")
        max_direct = int.from_bytes(head[120:128], "little")
        max_heap_bits = int.from_bytes(head[128:130], "little")
        self.root = int.from_bytes(head[132:140], "little")
        self.rows = int.from_bytes(head[140:142], "little")
        self.off_size = (max_heap_bits + 7) // 8
        self.len_size = min((_log2(max_direct) + 7) // 8, _enc_size(max_man))
        self.direct_rows = _log2(max_direct) - _log2(self.start) + 2
        self._children = None

    def _row_size(self, row: int) -> int:
        return self.start if row == 0 else self.start << (row - 1)

    def _root_children(self) -> List[int]:
        if self._children is None:
            n = min(self.rows, self.direct_rows) * self.width
            indirect = max(self.rows - self.direct_rows, 0) * self.width
            size = 4 + 1 + 8 + self.off_size + 8 * (n + indirect) + 4
            block = _block(self.store, self.root, size, b"FHIB", "fractal heap indirect block")
            base = 4 + 1 + 8 + self.off_size
            self._children = [int.from_bytes(block[base + 8 * i:base + 8 * i + 8], "little") for i in range(n)]
        return self._children

    def read(self, heap_id: bytes) -> bytes:
        kind = (heap_id[0] >> 4) & 3
        if kind == 2:
            if self.id_len > 18:
                n = ((heap_id[0] & 0x0F) << 8 | heap_id[1]) + 1
                return bytes(heap_id[2:2 + n])
            n = (heap_id[0] & 0x0F) + 1
            return bytes(heap_id[1:1 + n])
        if kind != 0:
            raise NotImplementedError("HDF5 huge fractal heap objects")
        offset = int.from_bytes(heap_id[1:1 + self.off_size], "little")
        length = int.from_bytes(heap_id[1 + self.off_size:1 + self.off_size + self.len_size], "little")
        if self.rows == 0:
            return self.store.pread(self.root + offset, length)
        if offset < self.start * self.width:
            row, col = 0, offset // self.start
        else:
            high = _log2(offset)
            row = high - (_log2(self.start) + _log2(self.width)) + 1
            col = (offset - (1 << high)) // self._row_size(row)
        if row >= self.direct_rows:
            raise NotImplementedError("HDF5 fractal heap with nested indirect blocks")
        block_offset = sum(self.width * self._row_size(r) for r in range(row)) + col * self._row_size(row)
        return self.store.pread(self._root_children()[row * self.width + col] + offset - block_offset, length)


def _dense_messages(store: "_Store", heap_addr: int, btree_addr: Optional[int], what: str) -> List[bytes]:
    """The link (``what`` "link") or attribute ("attribute") messages of a dense group or
    object: the name index's records point at them in the fractal heap."""
    heap = _FractalHeap(store, heap_addr)
    if btree_addr is None:
        return []
    btype, records = _btree2_records(store, btree_addr)
    if (what, btype) == ("link", 5):
        return [heap.read(r[4:4 + heap.id_len]) for r in records]
    if (what, btype) == ("attribute", 8):
        return [heap.read(r[:heap.id_len]) for r in records]
    raise OSError(f"HDF5 dense {what} storage with a name index of record type {btype}")


# ---------------------------------------------------------------------------------------------
# the file


def _open_flags(mode: str) -> Tuple[int, bool, bool]:
    """(os.open flags, writable, create) for an h5py mode."""
    if mode == "r":
        return os.O_RDONLY, False, False
    if mode == "r+":
        return os.O_RDWR, True, False
    if mode == "w":
        return os.O_RDWR | os.O_CREAT, True, True  # truncated once the lock is held
    if mode in ("w-", "x"):
        return os.O_RDWR | os.O_CREAT | os.O_EXCL, True, True
    raise ValueError(f"Invalid mode; must be one of r, r+, w, w-, x, a (got {mode!r})")


def _lock(fd: int, writable: bool, path: str) -> None:
    """HDF5's file lock: shared for reading, exclusive for writing, refused at once where another
    handle (of this program or of an HDF5 program) holds the file otherwise; off where
    ``HDF5_USE_FILE_LOCKING`` is FALSE, as in HDF5, and skipped where the file system has no locks."""
    if os.environ.get("HDF5_USE_FILE_LOCKING", "").upper() in ("FALSE", "0"):
        return
    import fcntl

    try:
        fcntl.flock(fd, (fcntl.LOCK_EX if writable else fcntl.LOCK_SH) | fcntl.LOCK_NB)
    except BlockingIOError as e:
        raise OSError(errno.EAGAIN, f"unable to lock the HDF5 file {path} for {'writing' if writable else 'reading'}: "
                      "another handle holds it (HDF5_USE_FILE_LOCKING=FALSE turns the lock off)") from e
    except OSError as e:
        if e.errno not in (errno.ENOSYS, errno.ENOTSUP, errno.EOPNOTSUPP):
            raise


class _Store:
    """The open file: positioned reads and writes, the superblock, and the caches of headers,
    groups and datasets, shared by every handle of the file."""

    def __init__(self, path: str, mode: str):
        self.path, self.mode = path, mode
        if mode == "a":
            mode = "r+" if os.path.exists(path) else "w-"
        flags, self.writable, create = _open_flags(mode)
        self.fd = os.open(path, flags | getattr(os, "O_CLOEXEC", 0), 0o644)
        try:
            _lock(self.fd, self.writable, path)
        except BaseException:
            os.close(self.fd)
            raise
        if create:
            os.ftruncate(self.fd, 0)
        self.lock = threading.RLock()
        self.headers: Dict[int, _Header] = {}
        self.groups: Dict[int, "_GroupState"] = {}
        self.datasets: Dict[int, "_DatasetState"] = {}
        self.gheaps: Dict[int, Dict[int, bytes]] = {}
        self.dirty = set()
        self._mm = None
        try:
            if create:
                self._create()
            else:
                self._read_superblock()
        except BaseException:
            os.close(self.fd)
            self.fd = None
            raise

    # -- raw access -----------------------------------------------------------------------------

    def pread(self, addr: int, n: int) -> bytes:
        data = os.pread(self.fd, n, self.base + addr)
        if len(data) != n:
            raise OSError(f"HDF5 file {self.path}: read of {n} bytes at {addr} ran past the end of the file")
        return data

    def pwrite(self, addr: int, data: bytes) -> None:
        os.pwrite(self.fd, data, self.base + addr)

    def alloc(self, n: int) -> int:
        addr = self.eof
        self.eof += n
        return addr

    def append(self, data: bytes) -> int:
        addr = self.alloc(len(data))
        self.pwrite(addr, data)
        return addr

    def memmap(self):
        """A read-only uint8 map of the whole file (mode "r" only), or None."""
        if self.writable:
            return None
        if self._mm is None:
            with self.lock:
                if self._mm is None and os.fstat(self.fd).st_size > 0:
                    self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        return self._mm

    def require_writable(self) -> None:
        if not self.writable:
            raise ValueError(f"HDF5 file {self.path} is open read-only")
        if self.sb_version > 1:
            raise NotImplementedError(
                f"writing into an HDF5 file of superblock version {self.sb_version} (libver 'latest'); "
                "the port writes the earliest format")

    # -- superblock -----------------------------------------------------------------------------

    def _read_superblock(self) -> None:
        size = os.fstat(self.fd).st_size
        base = 0
        while True:
            if base + 8 > size:
                raise OSError(f"{self.path} is not an HDF5 file (no superblock signature)")
            if os.pread(self.fd, 8, base) == SIGNATURE:
                break
            base = 512 if base == 0 else base * 2
        self.base = 0
        head = os.pread(self.fd, 256, base)
        version = head[8]
        self.sb_version = version
        self.leaf_k, self.internal_k, self.chunk_k = 4, 16, 32
        if version in (0, 1):
            self.osz, self.lsz = head[13], head[14]
            cur = _Cursor(head, 16, self.osz, self.lsz)
            self.leaf_k, self.internal_k = cur.u(2), cur.u(2)
            cur.u(4)
            if version == 1:
                self.chunk_k = cur.u(2)
                cur.u(2)
            base_addr = cur.addr()
            cur.addr()
            self.eof_pos = cur.pos
            eof = cur.addr()
            cur.addr()
            self.root_entry_pos = cur.pos
            cur.addr()
            self.root = cur.addr()
        elif version in (2, 3):
            self.osz, self.lsz = head[9], head[10]
            cur = _Cursor(head, 12, self.osz, self.lsz)
            base_addr = cur.addr()
            cur.addr()  # superblock extension
            self.eof_pos = cur.pos
            eof = cur.addr()
            self.root = cur.addr()
            _check(head[:cur.pos + 4], "superblock")
        else:
            raise NotImplementedError(f"HDF5 superblock version {version}")
        if self.osz != 8 or self.lsz != 8:
            raise NotImplementedError(f"HDF5 files with {self.osz}-byte offsets and {self.lsz}-byte lengths")
        self.base = base_addr if base_addr is not None else base
        self.eof = max(eof or 0, size - self.base)

    def _create(self) -> None:
        self.base, self.sb_version, self.osz, self.lsz = 0, 0, 8, 8
        self.leaf_k, self.internal_k, self.chunk_k = 4, 16, 32
        self.eof_pos, self.root_entry_pos = 40, 56
        self.eof = 96
        btree, heap = self._new_group_storage()
        self.root = self.write_header([_Message(SYMBOL_TABLE, 0, _addr(btree) + _addr(heap))])
        sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + _u(self.leaf_k, 2) + _u(self.internal_k, 2)
              + _u(0, 4) + _addr(0) + _addr(None) + _addr(self.eof) + _addr(None)
              + _u(0, 8) + _addr(self.root) + _u(1, 4) + _u(0, 4) + _addr(btree) + _addr(heap))
        self.pwrite(0, sb)

    def flush(self) -> None:
        if not self.writable or self.fd is None:
            return
        with self.lock:
            for state in list(self.dirty):
                state.flush()
            self.dirty.clear()
            if os.fstat(self.fd).st_size < self.base + self.eof:
                os.ftruncate(self.fd, self.base + self.eof)
            if self.sb_version <= 1:
                self.pwrite(self.eof_pos, _addr(self.eof))

    def close(self) -> None:
        if self.fd is None:
            return
        try:
            self.flush()
        finally:
            os.close(self.fd)
            self.fd = None
            self._mm = None

    # -- object headers -------------------------------------------------------------------------

    def header(self, addr: int) -> _Header:
        with self.lock:
            h = self.headers.get(addr)
            if h is None:
                h = self.headers[addr] = self._read_header(addr)
            return h

    def _read_header(self, addr: int) -> _Header:
        prefix = self.pread(addr, 16)
        if prefix[:4] == b"OHDR":
            return self._read_header_v2(addr)
        if prefix[0] != 1:
            raise NotImplementedError(f"HDF5 object header version {prefix[0]}")
        nmesgs, refcount, size0 = struct.unpack_from("<HII", prefix, 2)
        chunks, messages, seen = [(addr + 16, size0)], [], 0
        while chunks:
            caddr, csize = chunks.pop(0)
            data = self.pread(caddr, csize)
            pos = 0
            while pos + 8 <= csize and seen < nmesgs:
                mtype, msize, mflags = struct.unpack_from("<HHB", data, pos)
                body = data[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                seen += 1
                if mtype == CONTINUATION:
                    cur = _Cursor(body)
                    chunks.append((cur.addr(), cur.length()))
                elif mtype != NIL:
                    messages.append(self._checked_message(mtype, mflags, body))
        return _Header(addr, 1, messages, size0, refcount)

    def _read_header_v2(self, addr: int) -> _Header:
        head = os.pread(self.fd, 40, self.base + addr)
        flags = head[5]
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        nsize = 1 << (flags & 3)
        size0 = int.from_bytes(head[pos:pos + nsize], "little")
        start = pos + nsize
        block = _check(self.pread(addr, start + size0 + 4), "object header")
        messages = []
        chunks = [(block, start)]
        while chunks:
            data, pos = chunks.pop(0)
            hsize = 6 if flags & 0x04 else 4
            while pos + hsize <= len(data):
                mtype, msize, mflags = data[pos], int.from_bytes(data[pos + 1:pos + 3], "little"), data[pos + 3]
                pos += hsize
                body = data[pos:pos + msize]
                pos += msize
                if mtype == CONTINUATION:
                    cur = _Cursor(body)
                    caddr, clen = cur.addr(), cur.length()
                    cont = self.pread(caddr, clen)
                    if cont[:4] != b"OCHK":
                        raise OSError("HDF5 object header continuation block without its OCHK signature")
                    chunks.append((_check(cont, "object header continuation"), 4))
                elif mtype != NIL:
                    messages.append(self._checked_message(mtype, mflags, body))
        return _Header(addr, 2, messages)

    @staticmethod
    def _checked_message(mtype: int, mflags: int, body: bytes) -> _Message:
        if mflags & 0x02:
            raise NotImplementedError(f"HDF5 shared object header message (type {mtype})")
        return _Message(mtype, mflags, body)

    def write_header(self, messages: List[_Message], addr: Optional[int] = None, chunk0_size: int = 0,
                     refcount: int = 1) -> int:
        """Write a v1 object header: a new one at the end of the file (``addr`` None; its first
        chunk leaves room for a few more messages), or over the one at ``addr``, whose first
        chunk keeps its size; messages that do not fit go to a new continuation block."""
        encoded = [(m.type, m.flags, m.data + b"\0" * (_pad8(len(m.data)) - len(m.data))) for m in messages]
        sizes = [8 + len(d) for _, _, d in encoded]
        if addr is None:
            chunk0_size = max(sum(sizes) + 8, 256)
            chunk0_size = _pad8(chunk0_size)
            addr = self.alloc(16 + chunk0_size)
        fits = sum(sizes) <= chunk0_size
        if fits:
            first, rest = encoded, []
        else:
            room, used, k = chunk0_size - 24, 0, 0
            while k < len(encoded) and used + sizes[k] <= room:
                used += sizes[k]
                k += 1
            first, rest = encoded[:k], encoded[k:]
        body = b"".join(_u(t, 2) + _u(len(d), 2) + bytes([f, 0, 0, 0]) + d for t, f, d in first)
        nmesgs = len(first)
        if rest:
            cont = b"".join(_u(t, 2) + _u(len(d), 2) + bytes([f, 0, 0, 0]) + d for t, f, d in rest)
            cont_size = _pad8(len(cont) + 8 + 128)
            cont += _u(NIL, 2) + _u(cont_size - len(cont) - 8, 2) + b"\0" * 4
            cont += b"\0" * (cont_size - len(cont))
            cont_addr = self.append(cont)
            body += _u(CONTINUATION, 2) + _u(16, 2) + b"\0" * 4 + _addr(cont_addr) + _u(cont_size, 8)
            nmesgs += len(rest) + 2
        if len(body) < chunk0_size:
            body += _u(NIL, 2) + _u(chunk0_size - len(body) - 8, 2) + b"\0" * 4
            body += b"\0" * (chunk0_size - len(body))
            nmesgs += 1
        prefix = bytes([1, 0]) + _u(nmesgs, 2) + _u(refcount, 4) + _u(chunk0_size, 4) + b"\0" * 4
        self.pwrite(addr, prefix + body)
        with self.lock:
            self.headers[addr] = _Header(addr, 1, list(messages), chunk0_size, refcount)
        return addr

    def rewrite_header(self, header: _Header) -> None:
        if header.version != 1:
            raise NotImplementedError("rewriting an HDF5 object header of version 2 (libver 'latest')")
        self.write_header(header.messages, header.addr, header.chunk0_size, header.refcount)

    # -- local and global heaps -----------------------------------------------------------------

    def local_heap(self, addr: int) -> Tuple[int, int, bytes]:
        """(data segment address, size, data) of the local heap at ``addr``."""
        head = self.pread(addr, 32)
        if head[:4] != b"HEAP":
            raise OSError("HDF5 local heap without its HEAP signature")
        cur = _Cursor(head, 8)
        size, _free, data_addr = cur.length(), cur.length(), cur.addr()
        return data_addr, size, self.pread(data_addr, size)

    def global_heap_object(self, addr: int, index: int) -> bytes:
        with self.lock:
            objects = self.gheaps.get(addr)
            if objects is None:
                head = self.pread(addr, 16)
                if head[:4] != b"GCOL":
                    raise OSError("HDF5 global heap collection without its GCOL signature")
                size = int.from_bytes(head[8:16], "little")
                data = self.pread(addr, size)
                objects, pos = {}, 16
                while pos + 16 <= size:
                    idx = int.from_bytes(data[pos:pos + 2], "little")
                    osize = int.from_bytes(data[pos + 8:pos + 16], "little")
                    if idx == 0:
                        break
                    objects[idx] = data[pos + 16:pos + 16 + osize]
                    pos += 16 + _pad8(osize)
                self.gheaps[addr] = objects
        return objects[index]

    def write_global_heap(self, payloads: Sequence[bytes]) -> int:
        """A new global heap collection of ``payloads`` (indexes 1, 2, ...), at least 4 KiB, as
        HDF5 reads collections."""
        body = b"".join(_u(i + 1, 2) + _u(1, 2) + b"\0" * 4 + _u(len(p), 8) + p + b"\0" * (_pad8(len(p)) - len(p))
                        for i, p in enumerate(payloads))
        size = max(4096, _pad8(16 + len(body) + 16))
        free = size - 16 - len(body)
        data = b"GCOL" + bytes([1, 0, 0, 0]) + _u(size, 8) + body + _u(0, 2) + _u(0, 2) + b"\0" * 4 + _u(free, 8)
        return self.append(data + b"\0" * (size - len(data)))

    # -- B-trees (v1) ---------------------------------------------------------------------------

    def btree_leaves(self, addr: int, key_size: int) -> List[Tuple[bytes, int, bytes]]:
        """(left key, child address, right key) of every level-0 entry of the v1 B-tree at
        ``addr``, in key order."""
        out = []
        head = self.pread(addr, 24)
        if head[:4] != b"TREE":
            raise OSError("HDF5 v1 B-tree node without its TREE signature")
        level, used = head[5], int.from_bytes(head[6:8], "little")
        body = self.pread(addr + 24, used * (key_size + 8) + key_size)
        step = key_size + 8
        for i in range(used):
            pos = i * step
            left = body[pos:pos + key_size]
            child = int.from_bytes(body[pos + key_size:pos + step], "little")
            right = body[pos + step:pos + step + key_size]
            if level == 0:
                out.append((left, child, right))
            else:
                out.extend(self.btree_leaves(child, key_size))
        return out

    def write_btree(self, root: int, node_type: int, k2: int, key_size: int,
                    children: List[int], keys: List[bytes]) -> None:
        """Write a v1 B-tree over ``children`` (``len(keys) == len(children) + 1``; keys[i] and
        keys[i + 1] bound child i), with its root node at ``root`` and every other node at the
        end of the file; each node takes the full size that HDF5 reads (``k2`` children)."""
        node_size = 24 + (k2 + 1) * key_size + k2 * 8
        level, kids, ks = 0, children, keys
        while len(kids) > k2:
            groups = [list(range(i, min(i + k2, len(kids)))) for i in range(0, len(kids), k2)]
            addrs = [self.alloc(node_size) for _ in groups]
            for j, g in enumerate(groups):
                left = addrs[j - 1] if j > 0 else None
                right = addrs[j + 1] if j + 1 < len(groups) else None
                self._write_node(addrs[j], node_type, level, [kids[i] for i in g],
                                 [ks[i] for i in g] + [ks[g[-1] + 1]], left, right, node_size)
            kids, ks = addrs, [ks[g[0]] for g in groups] + [ks[groups[-1][-1] + 1]]
            level += 1
        self._write_node(root, node_type, level, kids, ks, None, None, node_size)

    def _write_node(self, addr, node_type, level, children, keys, left, right, node_size) -> None:
        body = b"TREE" + bytes([node_type, level]) + _u(len(children), 2) + _addr(left) + _addr(right)
        for key, child in zip(keys, children):
            body += key + _u(child, 8)
        body += keys[len(children)]
        self.pwrite(addr, body + b"\0" * (node_size - len(body)))

    # -- groups ---------------------------------------------------------------------------------

    def _new_group_storage(self) -> Tuple[int, int]:
        """(B-tree root, local heap) of a new, empty symbol-table group."""
        heap_data = b"\0" * 8
        heap = self.alloc(32 + len(heap_data))
        self.pwrite(heap, b"HEAP" + bytes([0, 0, 0, 0]) + _u(len(heap_data), 8) + _u(H5HL_FREE_NULL, 8)
                    + _addr(heap + 32) + heap_data)
        k2 = 2 * self.internal_k
        btree = self.alloc(24 + (k2 + 1) * 8 + k2 * 8)
        self._write_node(btree, 0, 0, [], [_u(0, 8)], None, None, 24 + (k2 + 1) * 8 + k2 * 8)
        return btree, heap

    def group_state(self, addr: int) -> "_GroupState":
        with self.lock:
            state = self.groups.get(addr)
            if state is None:
                state = self.groups[addr] = _GroupState(self, addr)
            return state

    def dataset_state(self, addr: int) -> "_DatasetState":
        with self.lock:
            state = self.datasets.get(addr)
            if state is None:
                state = self.datasets[addr] = _DatasetState(self, addr)
            return state

    def kind(self, addr: int) -> str:
        types = {m.type for m in self.header(addr).messages}
        if LAYOUT in types:
            return "dataset"
        if types & {SYMBOL_TABLE, LINK_INFO, GROUP_INFO, LINK}:
            return "group"
        if DATATYPE in types:
            raise NotImplementedError("HDF5 committed (named) datatype objects")
        return "group"


class _Entry:
    """A group member: ``addr`` of its object header, or a ``soft`` link's path; for a
    symbol-table group also its heap name offset and its cache fields."""

    __slots__ = ("addr", "soft", "name_offset", "cache")

    def __init__(self, addr: Optional[int], soft: Optional[str] = None, name_offset: int = 0,
                 cache: bytes = b"\0" * 24):
        self.addr, self.soft, self.name_offset, self.cache = addr, soft, name_offset, cache


class _GroupState:
    """The members of one group, read once; a symbol-table group is rewritten on change."""

    def __init__(self, store: _Store, addr: int):
        self.store, self.addr = store, addr
        header = store.header(addr)
        stab = header.find(SYMBOL_TABLE)
        self.entries: Dict[str, _Entry] = {}
        if stab is not None:
            cur = _Cursor(stab.data)
            self.btree, self.heap = cur.addr(), cur.addr()
            self.heap_data_addr, self.heap_size, heap = store.local_heap(self.heap)
            self.heap_bytes = bytearray(heap)
            for _, snod, _ in store.btree_leaves(self.btree, 8):
                self._read_snod(snod)
        else:
            self.btree = None
            info = header.find(LINK_INFO)
            if info is not None:
                cur = _Cursor(info.data)
                cur.u(1)
                lflags = cur.u(1)
                if lflags & 1:
                    cur.u(8)
                heap = cur.addr()
                if heap is not None:
                    for data in _dense_messages(store, heap, cur.addr(), "link"):
                        name, entry = self._decode_link(data)
                        self.entries[name] = entry
            for m in header.all(LINK):
                name, entry = self._decode_link(m.data)
                self.entries[name] = entry

    def _read_snod(self, addr: int) -> None:
        head = self.store.pread(addr, 8)
        if head[:4] != b"SNOD":
            raise OSError("HDF5 symbol-table node without its SNOD signature")
        n = int.from_bytes(head[6:8], "little")
        body = self.store.pread(addr + 8, 40 * n)
        for i in range(n):
            e = body[40 * i:40 * (i + 1)]
            offset = int.from_bytes(e[0:8], "little")
            obj = int.from_bytes(e[8:16], "little")
            cache_type = int.from_bytes(e[16:20], "little")
            end = self.heap_bytes.index(b"\0", offset)
            name = self.heap_bytes[offset:end].decode("utf-8")
            soft = None
            if cache_type == 2:
                link_offset = int.from_bytes(e[24:28], "little")
                soft = self.heap_bytes[link_offset:self.heap_bytes.index(b"\0", link_offset)].decode("utf-8")
            self.entries[name] = _Entry(None if soft is not None else obj, soft, offset, bytes(e[16:40]))

    @staticmethod
    def _decode_link(data) -> Tuple[str, _Entry]:
        cur = _Cursor(data)
        cur.u(1)
        flags = cur.u(1)
        ltype = cur.u(1) if flags & 0x08 else 0
        if flags & 0x04:
            cur.u(8)
        if flags & 0x10:
            cur.u(1)
        name = cur.take(cur.u(1 << (flags & 3))).decode("utf-8")
        if ltype == 0:
            return name, _Entry(cur.addr())
        if ltype == 1:
            return name, _Entry(None, cur.take(cur.u(2)).decode("utf-8"))
        raise NotImplementedError(f"HDF5 external or user-defined link {name!r} (link type {ltype})")

    # -- changes ---------------------------------------------------------------------------------

    def _require_stab(self) -> None:
        self.store.require_writable()
        if self.btree is None:
            raise NotImplementedError("changing an HDF5 group of link messages (libver 'latest')")

    def insert(self, name: str, addr: int, cache: bytes = b"\0" * 24) -> None:
        self._require_stab()
        if not name or "/" in name:
            raise ValueError(f"invalid HDF5 link name {name!r}")
        if name in self.entries:
            raise ValueError(f"Unable to create link (name already exists): {name!r}")
        raw = name.encode("utf-8") + b"\0"
        offset = len(self.heap_bytes)
        self.heap_bytes += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        self.entries[name] = _Entry(addr, None, offset, cache)
        self._heap_dirty = True
        self.store.dirty.add(self)

    def delete(self, name: str) -> None:
        self._require_stab()
        if name not in self.entries:
            raise KeyError(f"Unable to delete {name!r}: it does not exist")
        del self.entries[name]
        self.store.dirty.add(self)

    def flush(self) -> None:
        store = self.store
        if getattr(self, "_heap_dirty", False):
            self.heap_data_addr = store.append(bytes(self.heap_bytes))
            self.heap_size = len(self.heap_bytes)
            store.pwrite(self.heap + 8, _u(self.heap_size, 8))
            store.pwrite(self.heap + 24, _addr(self.heap_data_addr))
            self._heap_dirty = False
        names = sorted(self.entries, key=lambda n: n.encode("utf-8"))
        leaf = 2 * store.leaf_k
        snods, keys = [], [_u(0, 8)]
        for i in range(0, len(names), leaf):
            part = names[i:i + leaf]
            body = b"SNOD" + bytes([1, 0]) + _u(len(part), 2)
            for n in part:
                e = self.entries[n]
                body += _u(e.name_offset, 8) + _addr(e.addr) + e.cache
            snods.append(store.append(body + b"\0" * (8 + 40 * leaf - len(body))))
            keys.append(_u(self.entries[part[-1]].name_offset, 8))
        store.write_btree(self.btree, 0, 2 * store.internal_k, 8, snods, keys)


class _DatasetState:
    """One dataset's metadata and chunk index, shared by its handles."""

    def __init__(self, store: _Store, addr: int):
        self.store, self.addr = store, addr
        self.lock = threading.Lock()
        header = store.header(addr)
        space, dtype_msg = header.find(DATASPACE), header.find(DATATYPE)
        if space is None or dtype_msg is None:
            raise OSError("HDF5 dataset without a dataspace or datatype message")
        shape, maxshape = _decode_dataspace(space.data)
        if shape is None:
            raise NotImplementedError("HDF5 dataset with a null dataspace (h5py.Empty)")
        self.shape, self.maxshape = shape, maxshape
        self.type = _decode_datatype(_Cursor(dtype_msg.data))
        if header.find(EXTERNAL) is not None:
            raise NotImplementedError("HDF5 dataset in external files")
        pipeline = header.find(FILTERS)
        self.filters = _decode_filters(pipeline.data) if pipeline is not None else []
        self.fill = self._fill(header)
        self._decode_layout(header.find(LAYOUT).data)
        self.index = None  # chunk grid coordinates -> (address, size, filter mask)

    @staticmethod
    def _fill(header: _Header) -> Optional[bytes]:
        """The fill value's bytes, or None for the default (zeros)."""
        msg = header.find(FILL)
        if msg is not None:
            cur = _Cursor(msg.data)
            version = cur.u(1)
            if version in (1, 2):
                cur.u(2)
                defined = cur.u(1)
                if version == 2 and not defined:
                    return None
            elif cur.u(1) & 0x20 == 0:
                return None
            size = cur.u(4)
            return cur.take(size) if size else None
        old = header.find(FILL_OLD)
        if old is not None:
            size = int.from_bytes(old.data[:4], "little")
            return old.data[4:4 + size] if size else None
        return None

    def _decode_layout(self, data) -> None:
        cur = _Cursor(data)
        version = cur.u(1)
        self.chunks, self.contiguous, self.compact, self.index_type = None, None, None, None
        if version in (1, 2):
            rank, cls = cur.u(1), cur.u(1)
            cur.u(5)
            address = cur.addr() if cls != 0 else None
            dims = [cur.u(4) for _ in range(rank)]
            if cls == 2:
                cur.u(4)
                self.chunks, self.index_type, self.index_addr = tuple(dims[:-1]), "btree1", address
            elif cls == 1:
                self.contiguous = (address, int(np.prod(self.shape)) * self.type.size)
            else:
                self.compact = cur.take(cur.u(4))
            return
        cls = cur.u(1)
        if cls == 0:
            self.compact = cur.take(cur.u(2))
        elif cls == 1:
            self.contiguous = (cur.addr(), cur.length())
        elif cls == 2 and version == 3:
            rank = cur.u(1)
            self.index_addr = cur.addr()
            dims = [cur.u(4) for _ in range(rank)]
            self.chunks, self.index_type = tuple(dims[:-1]), "btree1"
        elif cls == 2 and version == 4:
            flags, rank, enc = cur.u(1), cur.u(1), cur.u(1)
            if flags & 1:
                raise NotImplementedError("HDF5 layout v4 with unfiltered partial edge chunks")
            dims = [cur.u(enc) for _ in range(rank)]
            self.chunks = tuple(dims[:-1])
            itype = cur.u(1)
            if itype == 1:
                self.single = (cur.length(), cur.u(4)) if flags & 2 else None
                self.index_type = "single"
            elif itype == 2:
                self.index_type = "implicit"
            elif itype == 3:
                cur.u(1)
                self.index_type = "fixed"
            elif itype == 4:
                cur.u(5)
                self.index_type = "earray"
            elif itype == 5:
                cur.u(6)
                self.index_type = "btree2"
            else:
                raise NotImplementedError(f"HDF5 chunk index type {itype}")
            self.index_addr = cur.addr()
        elif cls == 3:
            raise NotImplementedError("HDF5 virtual dataset layout")
        else:
            raise NotImplementedError(f"HDF5 data layout message version {version}, class {cls}")

    # -- the chunk index ------------------------------------------------------------------------

    @property
    def chunk_bytes(self) -> int:
        return int(np.prod(self.chunks)) * self.type.size

    def grid(self, shape=None) -> Tuple[int, ...]:
        shape = self.shape if shape is None else shape
        return tuple(-(-s // c) for s, c in zip(shape, self.chunks))

    def chunk_index(self) -> Dict[Tuple[int, ...], Tuple[int, int, int]]:
        if self.index is None:
            with self.lock:
                if self.index is None:
                    self.index = self._read_index()
        return self.index

    def _read_index(self) -> Dict[Tuple[int, ...], Tuple[int, int, int]]:
        store, index = self.store, {}
        if self.index_addr is None:
            return index
        rank = len(self.chunks)
        if self.index_type == "btree1":
            key_size = 8 + 8 * (rank + 1)
            for left, child, _ in store.btree_leaves(self.index_addr, key_size):
                size, mask = struct.unpack_from("<II", left, 0)
                offsets = struct.unpack_from(f"<{rank}Q", left, 8)
                index[tuple(o // c for o, c in zip(offsets, self.chunks))] = (child, size, mask)
            return index
        if self.index_type == "single":
            size, mask = self.single if self.single is not None else (self.chunk_bytes, 0)
            index[(0,) * rank] = (self.index_addr, size, mask)
            return index
        if self.index_type == "btree2":
            btype, records = _btree2_records(store, self.index_addr)
            for r in records:
                addr = int.from_bytes(r[:8], "little")
                if btype == 11:
                    size_len = len(r) - 8 - 4 - 8 * rank
                    size = int.from_bytes(r[8:8 + size_len], "little")
                    mask = int.from_bytes(r[8 + size_len:12 + size_len], "little")
                else:
                    size, mask = self.chunk_bytes, 0
                index[struct.unpack_from(f"<{rank}Q", r, len(r) - 8 * rank)] = (addr, size, mask)
            return index
        if self.index_type == "earray":
            esize, elements = _earray_elements(store, self.index_addr)
            k = self.maxshape.index(None)  # the one unlimited axis, slowest in the array's order
            others = [g for i, g in enumerate(self.grid(self.maxshape[:k] + (1,) + self.maxshape[k + 1:])) if i != k]
            per_row = int(np.prod(others))
            for i, raw in enumerate(elements):
                entry = None if raw is None else self._chunk_entry(raw, esize)
                if entry is not None:
                    rest = np.unravel_index(i % per_row, others) if others else ()
                    coords = tuple(int(v) for v in rest[:k]) + (i // per_row,) + tuple(int(v) for v in rest[k:])
                    index[coords] = entry
            return index
        max_grid = self.grid(tuple(s if m is None else m for s, m in zip(self.shape, self.maxshape)))
        if self.index_type == "implicit":
            for linear, coords in enumerate(itertools.product(*(range(g) for g in max_grid))):
                index[coords] = (self.index_addr + linear * self.chunk_bytes, self.chunk_bytes, 0)
            return index
        entries = self._fixed_array(self.index_addr)
        for coords, entry in zip(itertools.product(*(range(g) for g in max_grid)), entries):
            if entry is not None:
                index[coords] = entry
        return index

    def _chunk_entry(self, raw: bytes, size: int, filtered: Optional[bool] = None):
        """(address, size, filter mask) of a fixed- or extensible-array element, None where unset."""
        addr = int.from_bytes(raw[:8], "little")
        if addr == UNDEF:
            return None
        if filtered is False or (filtered is None and size == 8):
            return addr, self.chunk_bytes, 0
        return addr, int.from_bytes(raw[8:size - 4], "little"), int.from_bytes(raw[size - 4:size], "little")

    def _fixed_array(self, addr: int) -> List[Optional[Tuple[int, int, int]]]:
        store = self.store
        head = store.pread(addr, 32)
        if head[:4] != b"FAHD":
            raise OSError("HDF5 fixed-array header without its FAHD signature")
        _check(head[:28], "fixed-array header")
        client, entry_size, page_bits = head[5], head[6], head[7]
        count = int.from_bytes(head[8:16], "little")
        data_addr = int.from_bytes(head[16:24], "little")
        if data_addr == UNDEF:
            return [None] * count
        page = 1 << page_bits
        prefix = 4 + 1 + 1 + 8
        filtered = client == 1

        def decode(raw, n):
            out = []
            for i in range(n):
                e = raw[i * entry_size:(i + 1) * entry_size]
                a = int.from_bytes(e[:8], "little")
                if a == UNDEF:
                    out.append(None)
                elif filtered:
                    size = int.from_bytes(e[8:entry_size - 4], "little")
                    out.append((a, size, int.from_bytes(e[entry_size - 4:], "little")))
                else:
                    out.append((a, self.chunk_bytes, 0))
            return out

        if count <= page:
            block = _check(store.pread(data_addr, prefix + count * entry_size + 4), "fixed-array data block")
            if block[:4] != b"FADB":
                raise OSError("HDF5 fixed-array data block without its FADB signature")
            return decode(block[prefix:], count)
        npages = -(-count // page)
        bitmap_len = -(-npages // 8)
        head_block = _check(store.pread(data_addr, prefix + bitmap_len + 4), "fixed-array data block")
        bitmap = head_block[prefix:]
        out, pos = [], data_addr + prefix + bitmap_len + 4
        for p in range(npages):
            n = min(page, count - p * page)
            size = n * entry_size + 4
            if bitmap[p // 8] & (0x80 >> (p % 8)):
                out.extend(decode(_check(store.pread(pos, size), "fixed-array page"), n))
            else:
                out.extend([None] * n)
            pos += size
        return out

    # -- reading --------------------------------------------------------------------------------

    def fill_array(self, shape) -> np.ndarray:
        if self.fill is None or not any(self.fill):
            return np.zeros(shape, dtype=self.type.dtype)
        return np.full(shape, np.frombuffer(self.fill, dtype=self.type.dtype)[0], dtype=self.type.dtype)

    def read_chunk(self, entry) -> np.ndarray:
        addr, size, mask = entry
        n = self.chunk_bytes
        unfiltered = not self.filters or mask == (1 << len(self.filters)) - 1
        mm = self.store.memmap() if unfiltered else None
        if mm is not None:
            raw = mm[self.store.base + addr:self.store.base + addr + n]
            return raw.view(self.type.dtype).reshape(self.chunks)
        raw = self.store.pread(addr, size)
        if not unfiltered:
            raw = _unfilter(raw, self.filters, mask, n, self.type.size)
        return np.frombuffer(raw, dtype=self.type.dtype, count=n // self.type.size).reshape(self.chunks)

    def read(self, ranges) -> np.ndarray:
        out_shape = tuple(_count(*r) for r in ranges)
        if self.compact is not None or self.contiguous is not None:
            if 0 in self.shape:
                return np.zeros(out_shape, dtype=self.type.dtype)
            whole = self._whole()
            return np.array(whole[tuple(slice(*r) for r in ranges)], copy=True)
        if 0 in out_shape:
            return np.zeros(out_shape, dtype=self.type.dtype)
        index = self.chunk_index()
        per_axis = []
        for (start, stop, step), c in zip(ranges, self.chunks):
            last = start + (_count(start, stop, step) - 1) * step
            spans = []
            for g in range(start // c, last // c + 1):
                o = _overlap((start, stop, step), g * c, (g + 1) * c)
                if o is not None:
                    spans.append((g, o))
            per_axis.append(spans)
        combos = list(itertools.product(*per_axis))
        complete = all(tuple(g for g, _ in combo) in index for combo in combos)
        out = np.empty(out_shape, dtype=self.type.dtype) if complete else self.fill_array(out_shape)
        for combo in combos:
            entry = index.get(tuple(g for g, _ in combo))
            if entry is None:
                continue
            chunk = self.read_chunk(entry)
            out[tuple(o[1] for _, o in combo)] = chunk[tuple(o[0] for _, o in combo)]
        return out

    def _whole(self) -> np.ndarray:
        if self.compact is not None:
            return np.frombuffer(self.compact, dtype=self.type.dtype,
                                 count=int(np.prod(self.shape))).reshape(self.shape)
        addr, size = self.contiguous
        if addr is None:
            return self.fill_array(self.shape)
        n = int(np.prod(self.shape)) * self.type.size
        mm = self.store.memmap()
        if mm is not None:
            raw = mm[self.store.base + addr:self.store.base + addr + n]
        else:
            raw = self.store.pread(addr, n)
        return np.frombuffer(raw, dtype=self.type.dtype).reshape(self.shape) if mm is None else \
            raw.view(self.type.dtype).reshape(self.shape)

    # -- writing --------------------------------------------------------------------------------

    def write(self, ranges, value: np.ndarray) -> None:
        store = self.store
        store.require_writable()
        if self.compact is not None:
            raise NotImplementedError("writing into a compact HDF5 dataset")
        if self.contiguous is not None:
            addr, _ = self.contiguous
            if 0 in self.shape:
                return
            view = np.memmap(store.path, dtype=self.type.dtype, mode="r+", offset=store.base + addr,
                             shape=self.shape)
            view[tuple(slice(*r) for r in ranges)] = value
            view.flush()
            del view
            return
        if self.index_type != "btree1":
            raise NotImplementedError(f"writing into an HDF5 dataset with a {self.index_type} chunk index")
        if any(_count(*r) == 0 for r in ranges):
            return
        index = self.chunk_index()
        per_axis = []
        for (start, stop, step), c in zip(ranges, self.chunks):
            last = start + (_count(start, stop, step) - 1) * step
            per_axis.append([(g, o) for g in range(start // c, last // c + 1)
                             for o in [_overlap((start, stop, step), g * c, (g + 1) * c)] if o is not None])
        for combo in itertools.product(*per_axis):
            coords = tuple(g for g, _ in combo)
            src = tuple(o[0] for _, o in combo)
            covers = all(s.start == 0 and s.step == 1 and s.stop >= min(c, n - g * c)
                         for s, c, n, g in zip(src, self.chunks, self.shape, coords))
            entry = index.get(coords)
            if covers or entry is None:
                chunk = self.fill_array(self.chunks)
            else:
                chunk = np.array(self.read_chunk(entry), copy=True)
            chunk[src] = value[tuple(o[1] for _, o in combo)]
            self.put_chunk(coords, chunk)

    def put_chunk(self, coords, chunk: np.ndarray) -> None:
        raw, mask = _apply_filters(np.ascontiguousarray(chunk, dtype=self.type.dtype).tobytes(),
                                   self.filters, self.type.size)
        self.chunk_index()[coords] = (self.store.append(raw), len(raw), mask)
        self.store.dirty.add(self)

    def resize(self, shape: Tuple[int, ...]) -> None:
        self.store.require_writable()
        if self.chunks is None:
            raise TypeError("Only chunked datasets can be resized")
        for s, m in zip(shape, self.maxshape):
            if m is not None and s > m:
                raise ValueError(f"new shape {shape} exceeds the maximum shape {self.maxshape}")
        old = self.shape
        index = self.chunk_index()
        if any(n < o for n, o in zip(shape, old)):
            grid = self.grid(shape)
            for coords in list(index):
                if any(g >= n for g, n in zip(coords, grid)):
                    del index[coords]
                elif any((g + 1) * c > n for g, c, n in zip(coords, self.chunks, shape)):
                    chunk = np.array(self.read_chunk(index[coords]), copy=True)
                    keep = tuple(slice(0, min(c, n - g * c)) for g, c, n in zip(coords, self.chunks, shape))
                    fresh = self.fill_array(self.chunks)
                    fresh[keep] = chunk[keep]
                    self.put_chunk(coords, fresh)
        self.shape = tuple(shape)
        header = self.store.header(self.addr)
        header.find(DATASPACE).data = _encode_dataspace(self.shape, self.maxshape)
        self._header_dirty = True
        self.store.dirty.add(self)

    def flush(self) -> None:
        store = self.store
        if self.chunks is not None and self.index is not None:
            rank = len(self.chunks)
            items = sorted(self.index.items())
            keys, children = [], []
            for coords, (addr, size, mask) in items:
                offsets = (g * c for g, c in zip(coords, self.chunks))
                keys.append(struct.pack(f"<II{rank + 1}Q", size, mask, *offsets, 0))
                children.append(addr)
            last = items[-1][0] if items else (0,) * rank
            keys.append(struct.pack(f"<II{rank + 1}Q", 0, 0, *((g + 1) * c for g, c in zip(last, self.chunks)), 0))
            if self.index_addr is None:
                k2 = 2 * store.chunk_k
                self.index_addr = store.alloc(24 + (k2 + 1) * len(keys[0]) + k2 * 8)
                header = store.header(self.addr)
                layout = header.find(LAYOUT)
                layout.data = _encode_chunked_layout(self.index_addr, self.chunks, self.type.size)
                self._header_dirty = True
            store.write_btree(self.index_addr, 1, 2 * store.chunk_k, len(keys[0]), children, keys)
        if getattr(self, "_header_dirty", False):
            store.rewrite_header(store.header(self.addr))
            self._header_dirty = False


def _encode_chunked_layout(btree: Optional[int], chunks, itemsize: int) -> bytes:
    return bytes([3, 2, len(chunks) + 1]) + _addr(btree) + b"".join(_u(c, 4) for c in chunks) + _u(itemsize, 4)


# ---------------------------------------------------------------------------------------------
# attributes


def _decode_attribute(store: _Store, data) -> Tuple[str, Any]:
    cur = _Cursor(data)
    version = cur.u(1)
    flags = cur.u(1)
    if flags & 3:
        raise NotImplementedError("HDF5 attribute with a shared datatype or dataspace")
    name_size, type_size, space_size = cur.u(2), cur.u(2), cur.u(2)
    if version == 3:
        cur.u(1)
    pad = _pad8 if version == 1 else (lambda n: n)
    name = cur.take(pad(name_size)).split(b"\0")[0].decode("utf-8")
    type_start = cur.pos
    cur.pos += pad(type_size)
    space = cur.take(pad(space_size))
    dtype = _decode_datatype(_Cursor(data, type_start))
    shape, _ = _decode_dataspace(space)
    if shape is None:
        raise NotImplementedError(f"HDF5 attribute {name!r} with a null dataspace (h5py.Empty)")
    n = int(np.prod(shape)) if shape else 1
    raw = data[cur.pos:cur.pos + n * dtype.size]
    return name, _attribute_value(store, dtype, shape, raw)


def _attribute_value(store: _Store, dtype: _Type, shape, raw: bytes):
    n = int(np.prod(shape)) if shape else 1
    if dtype.kind in ("vlen_str", "vlen_bytes"):
        values = []
        for i in range(n):
            e = raw[16 * i:16 * (i + 1)]
            length = int.from_bytes(e[:4], "little")
            collection, index = int.from_bytes(e[4:12], "little"), int.from_bytes(e[12:16], "little")
            payload = store.global_heap_object(collection, index)[:length] if collection not in (0, UNDEF) else b""
            values.append(payload.decode("utf-8"))
        if not shape:
            return values[0]
        return np.array(values, dtype=object).reshape(shape)
    arr = np.frombuffer(raw, dtype=dtype.dtype, count=n)
    if dtype.kind == "bool":
        arr = arr.astype(bool)
    if dtype.kind == "str":
        strings = [v.decode("utf-8") for v in arr.tolist()]
        return strings[0] if not shape else np.array(strings, dtype=object).reshape(shape)
    if dtype.kind == "bytes" and not shape:
        return arr[0]
    if not shape:
        return arr[0]
    return arr.reshape(shape).copy()


def _encode_attribute(store: _Store, name: str, value) -> bytes:
    """An attribute message (version 1) for a number, an array, a ``str`` (a variable-length
    UTF-8 string in a new global heap collection) or ``bytes``, as h5py stores them."""
    strings = isinstance(value, (list, tuple)) and value and all(isinstance(v, str) for v in value)
    if isinstance(value, str) or strings or (isinstance(value, np.ndarray) and value.dtype.kind in "OU"):
        strings = [value] if isinstance(value, str) else [str(v) for v in np.asarray(value, dtype=object).ravel()]
        shape = () if isinstance(value, str) else np.asarray(value, dtype=object).shape
        payloads = [s.encode("utf-8") for s in strings]
        heap = store.write_global_heap(payloads)
        raw = b"".join(_u(len(p), 4) + _addr(heap) + _u(i + 1, 4) for i, p in enumerate(payloads))
        dtype_raw = _vlen_str_datatype()
    else:
        arr = np.asarray(value)
        if arr.dtype.kind == "U":
            arr = arr.astype("S")
        if arr.dtype == np.int64 and not isinstance(value, np.ndarray):
            arr = arr.astype("<i8")
        shape = arr.shape
        raw = np.ascontiguousarray(arr).tobytes()
        dtype_raw = _encode_datatype(arr.dtype)
    space = _encode_dataspace(shape)
    name_raw = name.encode("utf-8") + b"\0"
    return (bytes([1, 0]) + _u(len(name_raw), 2) + _u(len(dtype_raw), 2) + _u(len(space), 2)
            + name_raw + b"\0" * (_pad8(len(name_raw)) - len(name_raw))
            + dtype_raw + b"\0" * (_pad8(len(dtype_raw)) - len(dtype_raw))
            + space + b"\0" * (_pad8(len(space)) - len(space)) + raw)


class AttributeManager(collections.abc.MutableMapping):
    """The attributes of a group or dataset, as a mapping (h5py's ``.attrs``)."""

    def __init__(self, owner: "_Object"):
        self._owner, self._addr = owner, owner._addr  # the owner keeps the file open

    @property
    def _store(self) -> _Store:
        return self._owner._file._store_or_raise()

    def _messages(self) -> Dict[str, _Message]:
        header = self._store.header(self._addr)
        info = header.find(ATTRIBUTE_INFO)
        if info is not None:
            cur = _Cursor(info.data)
            cur.u(1)
            if cur.u(1) & 1:
                cur.u(2)
            heap = cur.addr()
            dense = [] if heap is None else [_Message(ATTRIBUTE, 0, d)
                                             for d in _dense_messages(self._store, heap, cur.addr(), "attribute")]
        else:
            dense = []
        out = {}
        for m in header.all(ATTRIBUTE) + dense:
            cur = _Cursor(m.data)
            version = cur.u(1)
            cur.u(1)
            name_size = cur.u(2)
            cur.pos = 8 if version < 3 else 9
            out[bytes(m.data[cur.pos:cur.pos + name_size]).split(b"\0")[0].decode("utf-8")] = m
        return out

    def __getitem__(self, name: str):
        msg = self._messages().get(name)
        if msg is None:
            raise KeyError(f"Can't open attribute (attribute {name!r} does not exist)")
        return _decode_attribute(self._store, msg.data)[1]

    def __setitem__(self, name: str, value) -> None:
        store = self._store
        store.require_writable()
        with store.lock:
            header = store.header(self._addr)
            old = self._messages().get(name)
            message = _Message(ATTRIBUTE, 0, _encode_attribute(store, name, value))
            if old is not None:
                header.messages[header.messages.index(old)] = message
            else:
                header.messages.append(message)
            store.rewrite_header(header)

    def __delitem__(self, name: str) -> None:
        store = self._store
        store.require_writable()
        with store.lock:
            header = store.header(self._addr)
            old = self._messages().get(name)
            if old is None:
                raise KeyError(f"Can't delete attribute (attribute {name!r} does not exist)")
            header.messages.remove(old)
            store.rewrite_header(header)

    def __iter__(self):
        return iter(list(self._messages()))

    def __len__(self) -> int:
        return len(self._messages())

    def __contains__(self, name) -> bool:
        return name in self._messages()

    def __repr__(self) -> str:
        return f"<Attributes of HDF5 object at {self._addr}>"


# ---------------------------------------------------------------------------------------------
# the public objects


def _join(parent: str, name: str) -> str:
    return "/" + "/".join(p for p in (parent.strip("/") + "/" + name.strip("/")).split("/") if p)


class _Object:
    def __init__(self, file: "File", addr: int, name: str):
        self._file, self._addr, self.name = file, addr, name

    @property
    def attrs(self) -> AttributeManager:
        return AttributeManager(self)

    def __reduce__(self):
        return _reopen, (self._file.filename, self._file._pickle_mode(), self.name)


def _reopen(filename: str, mode: str, name: str):
    f = File(filename, mode)
    return f if name == "/" else f[name]


class Group(_Object, collections.abc.Mapping):
    """A group: a mapping of names (and paths) to groups and datasets."""

    def _state(self) -> _GroupState:
        return self._file._store_or_raise().group_state(self._addr)

    def _resolve(self, path: str, create_groups: bool = False) -> Tuple["Group", str]:
        """(parent group, last name) of ``path`` below this group."""
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError("an empty name")
        group = self._file if path.startswith("/") else self
        for p in parts[:-1]:
            if p not in group._state().entries and create_groups:
                group = group.create_group(p)
            else:
                item = group._get_one(p)
                if not isinstance(item, Group):
                    raise TypeError(f"{item.name} is not a group")
                group = item
        return group, parts[-1]

    def _get_one(self, name: str):
        entry = self._state().entries.get(name)
        if entry is None:
            raise KeyError(f"Unable to open object (object {name!r} doesn't exist)")
        path = _join(self.name, name)
        if entry.soft is not None:
            return self._file[entry.soft] if entry.soft.startswith("/") else self[entry.soft]
        store = self._file._store_or_raise()
        if store.kind(entry.addr) == "dataset":
            return Dataset(self._file, entry.addr, path)
        return Group(self._file, entry.addr, path)

    def __getitem__(self, name: str):
        if name in ("/", ""):
            return self._file if name == "/" else self
        parent, last = self._resolve(name)
        return parent._get_one(last)

    def __contains__(self, name) -> bool:
        if not isinstance(name, str):
            return False
        if name == "/":
            return True
        try:
            parent, last = self._resolve(name)
        except (KeyError, TypeError, ValueError):
            return False
        return last in parent._state().entries

    def __iter__(self):
        return iter(sorted(self._state().entries, key=lambda n: n.encode("utf-8")))

    def __len__(self) -> int:
        return len(self._state().entries)

    def __delitem__(self, name: str) -> None:
        store = self._file._store_or_raise()
        with store.lock:
            parent, last = self._resolve(name)
            parent._state().delete(last)

    def create_group(self, name: str) -> "Group":
        store = self._file._store_or_raise()
        with store.lock:
            store.require_writable()
            parent, last = self._resolve(name, create_groups=True)
            btree, heap = store._new_group_storage()
            addr = store.write_header([_Message(SYMBOL_TABLE, 0, _addr(btree) + _addr(heap))])
            parent._state().insert(last, addr, _u(1, 4) + _u(0, 4) + _addr(btree) + _addr(heap))
            return Group(self._file, addr, _join(parent.name, last))

    def create_dataset(self, name: str, shape=None, dtype=None, data=None, chunks=None, maxshape=None,
                       compression=None, compression_opts=None, shuffle=None, fletcher32=None) -> "Dataset":
        """h5py's ``create_dataset``: ``chunks`` None, True or a tuple; ``compression`` "gzip"
        (``compression_opts`` its level, 4 by default), "lzf" or None (an integer 0-9 is gzip
        at that level); ``shuffle``, ``fletcher32``; ``maxshape`` with None for an unlimited axis.
        The fill value is the default, zeros."""
        store = self._file._store_or_raise()
        if data is not None:
            if isinstance(data, Dataset):
                data = data[()]
            data = np.asarray(data)
            if dtype is not None:
                data = data.astype(dtype)
            if data.dtype.kind == "U":
                data = data.astype("S")
            if shape is not None and tuple(shape) != data.shape:
                if int(np.prod(shape)) != data.size:
                    raise ValueError(f"shape {tuple(shape)} does not match the data's {data.shape}")
                data = data.reshape(shape)
            shape, dtype = data.shape, data.dtype
        if shape is None:
            raise TypeError("One of data, shape or dtype must be specified")
        shape = (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)
        dtype = np.dtype("f4" if dtype is None else dtype)
        if isinstance(compression, int) and not isinstance(compression, bool):
            compression, compression_opts = "gzip", compression
        filters = []
        if shuffle:
            filters.append(_Filter(2, OPTIONAL_FILTER, [dtype.itemsize], "shuffle"))
        if compression == "gzip":
            level = DEFAULT_GZIP if compression_opts is None else int(compression_opts)
            if not 0 <= level <= 9:
                raise ValueError(f"GZIP setting must be an integer from 0-9, not {compression_opts!r}")
            filters.append(_Filter(1, OPTIONAL_FILTER, [level], "deflate"))
        elif compression == "lzf":
            filters.append(_Filter(32000, OPTIONAL_FILTER, [4, 0x0105, 0], "lzf"))
        elif compression is not None:
            raise NotImplementedError(f"the HDF5 compression filter {compression!r}; the port writes gzip and lzf")
        if fletcher32:
            filters.append(_Filter(3, 0, [], "fletcher32"))
        if maxshape is True:
            maxshape = (None,) * len(shape)
        if maxshape is not None:
            maxshape = tuple(None if m is None else int(m) for m in maxshape)
            if len(maxshape) != len(shape):
                raise ValueError('"maxshape" must have same rank as dataset shape')
        if chunks is True or (chunks is None and (filters or (maxshape is not None and maxshape != shape))):
            if not shape:
                raise TypeError("Scalar datasets don't support chunk/filter options")
            chunks = guess_chunk(shape, maxshape, dtype.itemsize)
        if chunks is not None:
            chunks = tuple(int(c) for c in chunks)
            if len(chunks) != len(shape):
                raise ValueError('"chunks" must have same rank as dataset shape')
            for c, s, m in zip(chunks, shape, maxshape or shape):
                if m is not None and c > max(m, s) and s > 0:
                    raise ValueError(f"Chunk shape must not be greater than data shape in any dimension. "
                                     f"{chunks} is not compatible with {shape}")
        for f in filters:
            if f.id == 32000:
                f.values = (4, 0x0105, int(np.prod(chunks)) * dtype.itemsize)
        with store.lock:
            store.require_writable()
            parent, last = self._resolve(name, create_groups=True)
            if last in parent._state().entries:
                raise ValueError(f"Unable to synchronously create dataset (name already exists): {last!r}")
            messages = [_Message(DATASPACE, 0, _encode_dataspace(shape, maxshape)),
                        _Message(DATATYPE, 1, _encode_datatype(dtype))]
            # the default fill value (zeros); space allocated early for contiguous data, chunk by chunk else
            messages.append(_Message(FILL, 1, bytes([2, 3 if chunks is not None else 1, 2, 1]) + _u(0, 4)))
            nbytes = int(np.prod(shape)) * dtype.itemsize
            if chunks is None:
                addr = store.alloc(nbytes) if nbytes else None
                if addr is not None and store.eof > os.fstat(store.fd).st_size - store.base:
                    os.ftruncate(store.fd, store.base + store.eof)  # reads as zeros until written
                messages.append(_Message(LAYOUT, 0, bytes([3, 1]) + _addr(addr) + _u(nbytes, 8)))
            else:
                messages.append(_Message(LAYOUT, 0, _encode_chunked_layout(None, chunks, dtype.itemsize)))
                if filters:
                    messages.append(_Message(FILTERS, 1, _encode_filters(filters)))
            addr = store.write_header(messages)
            parent._state().insert(last, addr)
            ds = Dataset(self._file, addr, _join(parent.name, last))
            state = ds._state()
            if chunks is not None:
                state.index = {}
                store.dirty.add(state)
            if data is not None and data.size:
                if chunks is None:
                    store.pwrite(state.contiguous[0], np.ascontiguousarray(data).tobytes())
                else:
                    grid = state.grid()
                    for coords in itertools.product(*(range(g) for g in grid)):
                        sl = tuple(slice(g * c, min((g + 1) * c, s)) for g, c, s in zip(coords, chunks, shape))
                        block = data[sl]
                        if block.shape != chunks:
                            full = state.fill_array(chunks)
                            full[tuple(slice(0, b) for b in block.shape)] = block
                            block = full
                        state.put_chunk(coords, block)
            return ds

    def __repr__(self) -> str:
        return f'<HDF5 group "{self.name}" ({len(self)} members)>'


class Dataset(_Object):
    """A dataset: ``shape``, ``dtype``, ``chunks``, ``maxshape``, ``compression``, ``attrs``;
    indexing by integers, slices (step >= 1) and ``Ellipsis`` reads (and writes) only the
    chunks the selection touches."""

    def _state(self) -> _DatasetState:
        return self._file._store_or_raise().dataset_state(self._addr)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._state().shape

    @property
    def dtype(self) -> np.dtype:
        t = self._state().type
        return np.dtype(bool) if t.kind == "bool" else t.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def chunks(self) -> Optional[Tuple[int, ...]]:
        return self._state().chunks

    @property
    def maxshape(self) -> Tuple[Optional[int], ...]:
        return self._state().maxshape

    @property
    def compression(self) -> Optional[str]:
        ids = [f.id for f in self._state().filters]
        return "gzip" if 1 in ids else "lzf" if 32000 in ids else None

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("Attempt to take len() of scalar dataset")
        return self.shape[0]

    def __getitem__(self, index):
        state = self._state()
        if state.type.kind == "vlen_str":
            raise NotImplementedError("reading an HDF5 dataset of variable-length strings")
        scalar = isinstance(index, tuple) and index == ()
        ranges, dropped = _normalize_index(index if not scalar else (Ellipsis,), state.shape)
        out = state.read(ranges)
        out = out.reshape(tuple(n for n, d in zip(out.shape, dropped) if not d))
        if state.type.kind == "bool":
            out = out.astype(bool)
        if scalar and not state.shape:
            return out[()]
        return out

    def __setitem__(self, index, value) -> None:
        state = self._state()
        with state.store.lock:
            ranges, dropped = _normalize_index(index, state.shape)
            target = tuple(_count(*r) for r in ranges)
            value = np.asarray(value)
            if state.type.kind == "bool":
                value = value.astype(bool)
            value = np.broadcast_to(value.astype(state.type.dtype, copy=False),
                                    tuple(n for n, d in zip(target, dropped) if not d)).reshape(target)
            state.write(ranges, value)

    def __array__(self, dtype=None, copy=None):
        data = self[()]
        data = np.asarray(data)
        return data.astype(dtype) if dtype is not None else data

    def resize(self, size, axis: Optional[int] = None) -> None:
        state = self._state()
        with state.store.lock:
            if axis is not None:
                shape = list(state.shape)
                shape[axis] = int(size)
            else:
                shape = [int(size)] if isinstance(size, (int, np.integer)) else [int(s) for s in size]
            if len(shape) != len(state.shape):
                raise TypeError("New shape length must match the rank of the dataset")
            state.resize(tuple(shape))

    def __repr__(self) -> str:
        return f'<HDF5 dataset "{self.name.rsplit("/", 1)[-1]}": shape {self.shape}, type "{self.dtype.str}">'


class File(Group):
    """An HDF5 file, opened in ``mode`` "r" (the default), "r+", "w", "w-"/"x" or "a"; the
    root group. Usable as a context manager; ``close()`` writes what is pending."""

    def __init__(self, name, mode: str = "r"):
        self.filename = os.fspath(name)
        self.mode = mode
        self._store = _Store(self.filename, mode)
        self._addr, self.name = self._store.root, "/"

    @property
    def _file(self) -> "File":  # the file is its own root group, with no reference to itself
        return self

    def _store_or_raise(self) -> _Store:
        if self._store.fd is None:
            raise ValueError(f"Not a location (the HDF5 file {self.filename} is closed)")
        return self._store

    def _pickle_mode(self) -> str:
        return "r+" if self.mode in ("w", "w-", "x") else self.mode

    def __reduce__(self):
        return _reopen, (self.filename, self._pickle_mode(), "/")

    def flush(self) -> None:
        self._store_or_raise().flush()

    def close(self) -> None:
        self._store.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        store = getattr(self, "_store", None)
        if store is not None and store.fd is not None:
            try:
                store.close()
            except Exception:
                pass

    def __repr__(self) -> str:
        state = "open" if self._store.fd is not None else "closed"
        return f'<HDF5 file "{os.path.basename(self.filename)}" (mode {self.mode}, {state})>'
