"""ctypes bindings for CRC-32C, the checksum of the TFRecord framing of TensorBoard's event files
(``utils/tensorboard.py``).

``crc32c.cpp`` beside this file is built with g++ at first use into
``torch_em_tpu_torch/_build/tem_crc32c-<hash>/`` (``ops/_build.py:compile_library``), as
``lzf.cpp`` is. A failed build raises; nothing falls back. ``crc32c_reference`` is a plain
table-driven Python version that the tests hold the native one against; at a few MB/s it
would add 0.1-0.3 s to each step that logs an image of about 1 MB.
"""

import ctypes
import functools
from pathlib import Path

from .._build import compile_library
from . import GXX_FLAGS, _find_gxx

__all__ = ["crc32c", "crc32c_reference", "load_library"]

SOURCE = Path(__file__).resolve().parent / "crc32c.cpp"
POLYNOMIAL = 0x82F63B78  # Castagnoli, bit-reflected


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build ``crc32c.cpp`` (once per content hash) and load it with its signature."""
    lib = ctypes.CDLL(str(compile_library("tem_crc32c", _find_gxx, GXX_FLAGS, [SOURCE])))
    lib.tem_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32]
    lib.tem_crc32c.restype = ctypes.c_uint32
    return lib


def crc32c(data: bytes) -> int:
    """The CRC-32C of ``data``."""
    data = bytes(data)
    return load_library().tem_crc32c(data, len(data), 0)


@functools.lru_cache(maxsize=None)
def _table():
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (POLYNOMIAL if crc & 1 else 0)
        table.append(crc)
    return tuple(table)


def crc32c_reference(data: bytes) -> int:
    """The CRC-32C of ``data``, one byte at a time in Python."""
    table, crc = _table(), 0xFFFFFFFF
    for byte in bytes(data):
        crc = (crc >> 8) ^ table[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF
