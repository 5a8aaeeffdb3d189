"""ctypes bindings for the LZF codec (HDF5 filter 32000) of ``utils/hdf5.py``.

``lzf.cpp`` beside this file is built with g++ at first use into
``torch_em_tpu_torch/_build/tem_lzf-<hash>/`` (``ops/_build.py:compile_library``), as
``tem_native.cpp`` is. A failed build raises; nothing falls back.
"""

import ctypes
import functools
from pathlib import Path
from typing import Optional

from .._build import compile_library
from . import GXX_FLAGS, _find_gxx

__all__ = ["compress", "decompress", "load_library"]

SOURCE = Path(__file__).resolve().parent / "lzf.cpp"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build ``lzf.cpp`` (once per content hash) and load it with its signatures."""
    lib = ctypes.CDLL(str(compile_library("tem_lzf", _find_gxx, GXX_FLAGS, [SOURCE])))
    for fn in (lib.tem_lzf_compress, lib.tem_lzf_decompress):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        fn.restype = ctypes.c_int64
    return lib


def compress(data: bytes) -> Optional[bytes]:
    """The LZF stream of ``data``, or None where it would not be shorter than ``data`` (HDF5's
    LZF filter then fails, and the optional filter is skipped for that chunk)."""
    data = bytes(data)
    out = ctypes.create_string_buffer(max(len(data) - 1, 1))
    n = load_library().tem_lzf_compress(data, len(data), out, len(data) - 1)
    return out.raw[:n] if n > 0 else None


def decompress(data: bytes, size: int) -> bytes:
    """The ``size`` bytes that the LZF stream ``data`` holds."""
    data = bytes(data)
    out = ctypes.create_string_buffer(max(size, 1))
    n = load_library().tem_lzf_decompress(data, len(data), out, size)
    if n == -2:
        raise ValueError(f"LZF stream decodes to more than the chunk's {size} bytes")
    if n < 0:
        raise ValueError("corrupt LZF stream")
    if n != size:
        raise ValueError(f"LZF stream decodes to {n} bytes, the chunk holds {size}")
    return out.raw[:n]
