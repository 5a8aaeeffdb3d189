"""ctypes bindings for the blosc codec of zarr v2 and N5 (``utils/zarr_n5.py``).

``blosc.cpp`` beside this file is built with g++ at first use into
``torch_em_tpu_torch/_build/tem_blosc-<hash>/`` (``ops/_build.py:compile_library``), as
``lzf.cpp`` is. A failed build raises; nothing falls back. It decodes c-blosc 1.x frames of
the codecs lz4, lz4hc and blosclz, and walks zlib frames while Python's ``zlib`` inflates their
streams; it encodes LZ4 frames with byte or bit shuffle. snappy and zstd raise
``NotImplementedError`` naming the codec. ctypes releases the GIL for each call, so loader
threads decode at once.
"""

import ctypes
import functools
import struct
import zlib
from pathlib import Path

import numpy as np

from .._build import compile_library
from . import GXX_FLAGS, _find_gxx

__all__ = ["compress", "decompress", "frame_header", "load_library", "CODECS"]

SOURCE = Path(__file__).resolve().parent / "blosc.cpp"
HEADER = 16
# the codec in bits 5-7 of the frame's flags
CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
SHUFFLES = {"none": 0, "byte": 1, "bit": 2}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build ``blosc.cpp`` (once per content hash) and load it with its signatures."""
    lib = ctypes.CDLL(str(compile_library("tem_blosc", _find_gxx, GXX_FLAGS, [SOURCE])))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tem_blosc_decompress.argtypes = [ptr, i64, ptr, i64]
    lib.tem_blosc_streams.argtypes = [ptr, i64, ptr, i64]
    lib.tem_blosc_unshuffle.argtypes = [ptr, i64, ptr, ptr]
    lib.tem_blosc_compress.argtypes = [ptr, i64, i64, ctypes.c_int, ctypes.c_int, ptr, i64]
    for fn in (lib.tem_blosc_decompress, lib.tem_blosc_streams, lib.tem_blosc_unshuffle, lib.tem_blosc_compress):
        fn.restype = i64
    return lib


def frame_header(frame) -> dict:
    """The 16-byte header of a blosc frame: version, flags, typesize, nbytes, blocksize, ctbytes and the
    codec's name."""
    if len(frame) < HEADER:
        raise ValueError(f"a blosc frame of {len(frame)} bytes is shorter than its 16-byte header")
    version, _, flags, typesize, nbytes, blocksize, ctbytes = struct.unpack("<BBBBIII", bytes(frame[:HEADER]))
    return {"version": version, "flags": flags, "typesize": typesize, "nbytes": nbytes, "blocksize": blocksize,
            "ctbytes": ctbytes, "codec": CODECS.get(flags >> 5, f"code {flags >> 5}")}


def _raise(code: int, header: dict):
    if code in (-3, -4, -6):
        raise NotImplementedError(f"blosc frames of the codec {header['codec']} are not read by the port "
                                  "(it reads lz4, lz4hc, blosclz and zlib)")
    if code == -7:
        raise NotImplementedError(f"blosc frame format version {header['version']} is not read by the port")
    if code == -8:
        raise MemoryError(f"no memory for a blosc block of {header['blocksize']} bytes")
    raise ValueError(f"corrupt blosc frame ({header['nbytes']} bytes in {header['ctbytes']})")


def _address(buffer: np.ndarray) -> int:
    return buffer.ctypes.data


def decompress(frame) -> np.ndarray:
    """The bytes that the blosc frame ``frame`` (bytes-like) holds, as a uint8 array."""
    src = np.frombuffer(frame, dtype=np.uint8)
    header = frame_header(src)
    out = np.empty(header["nbytes"], dtype=np.uint8)
    lib = load_library()
    code = lib.tem_blosc_decompress(_address(src), src.size, _address(out), out.size)
    if code == -5:
        return _inflate(lib, src, header, out)
    if code < 0:
        _raise(code, header)
    return out


def _inflate(lib, src: np.ndarray, header: dict, out: np.ndarray) -> np.ndarray:
    """A zlib frame: the C++ side lists the streams, Python's zlib inflates each, the C++ side unshuffles."""
    rows = header["nbytes"] // max(header["blocksize"], 1) + 1
    table = np.empty((rows * max(header["typesize"], 1), 4), dtype=np.int64)
    n = lib.tem_blosc_streams(_address(src), src.size, _address(table), table.shape[0])
    if n < 0:
        _raise(n, header)
    staged = np.empty(header["nbytes"], dtype=np.uint8)
    for offset, cbytes, dst, size in table[:n].tolist():
        stream = src[offset:offset + cbytes]
        data = stream if cbytes == size else np.frombuffer(zlib.decompress(stream, bufsize=size), dtype=np.uint8)
        if data.size != size:
            raise ValueError(f"a zlib stream of a blosc frame inflates to {data.size} bytes, not {size}")
        staged[dst:dst + size] = data
    code = lib.tem_blosc_unshuffle(_address(src), src.size, _address(staged), _address(out))
    if code < 0:
        _raise(code, header)
    return out


def compress(data: np.ndarray, typesize: int, shuffle: str = "byte", clevel: int = 5) -> bytes:
    """The blosc LZ4 frame of ``data``'s bytes (C order), with ``shuffle`` "none", "byte" or "bit" over
    elements of ``typesize`` bytes."""
    src = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    out = np.empty(src.size + HEADER, dtype=np.uint8)
    n = load_library().tem_blosc_compress(_address(src), src.size, typesize, SHUFFLES[shuffle], clevel,
                                          _address(out), out.size)
    if n == -8:
        raise MemoryError(f"no memory to compress {src.size} bytes into a blosc frame")
    if n < 0:
        raise ValueError(f"a blosc frame holds at most 2 GiB; got {src.size} bytes")
    return out[:n].tobytes()
