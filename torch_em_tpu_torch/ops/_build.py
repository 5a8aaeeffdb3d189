"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) with a plain
``extern "C"`` interface and loaded through :mod:`ctypes`; no PyTorch headers
are included, so a build takes seconds. The output goes to
``torch_em_tpu_torch/_build/<name>-<hash>/``, where the hash covers the
sources and the compiler flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The headers in ``csrc/`` (``*.cuh``) count
as sources of every library. ``compile_library`` also builds the host C++
library of ``ops/native`` with ``g++``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "find_nvcc", "compile_library", "load_library"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc was not found on PATH, under $CUDA_HOME or in /usr/local/cuda/bin; "
        "the CUDA toolkit is needed to build the port's kernels"
    )


def compile_library(name: str, find_compiler, flags, paths) -> Path:
    """``<compiler> *flags -o lib<name>.so *paths`` (headers left out of the command) once
    per hash of the flags and the files' contents, under ``BUILD_DIR/<name>-<hash>/``;
    ``find_compiler()`` is called only when a build is needed. Returns the library's path."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        digest.update(p.read_bytes())
    out_dir = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}"
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.is_file():
        command = find_compiler()
        out_dir.mkdir(parents=True, exist_ok=True)
        # build under a temporary name and rename, so a concurrent or cut-off
        # build never leaves a partial library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            proc = subprocess.run(
                [command, *flags, "-o", tmp, *(str(p) for p in paths if p.suffix != ".cuh")],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{os.path.basename(command)} failed to build {name} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return lib_path


@functools.lru_cache(maxsize=None)
def load_library(name: str, *sources: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` files into ``lib<name>.so`` (once per content hash) and load it."""
    paths = [CSRC_DIR / s for s in sources] + sorted(CSRC_DIR.glob("*.cuh"))
    return ctypes.CDLL(str(compile_library(name, find_nvcc, NVCC_FLAGS, paths)))
