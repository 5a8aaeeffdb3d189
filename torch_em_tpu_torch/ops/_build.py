"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) with a plain
``extern "C"`` interface and loaded through :mod:`ctypes`; no PyTorch headers
are included, so a build takes seconds. The output goes to
``torch_em_tpu_torch/_build/<name>-<hash>/``, where the hash covers the
sources and the compiler flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The headers in ``csrc/`` (``*.cuh``) count
as sources of every library.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "find_nvcc", "load_library"]

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


@functools.lru_cache(maxsize=None)
def load_library(name: str, *sources: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` files into ``lib<name>.so`` (once per content hash) and load it."""
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(p.read_bytes())
    out_dir = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}"
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.is_file():
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        # build under a temporary name and rename, so a concurrent or cut-off
        # build never leaves a partial library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, paths)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {name} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(str(lib_path))
