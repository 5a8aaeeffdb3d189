"""The port imports nothing of JAX, flax or the JAX package.

The machine with the card has PyTorch, numpy and scipy but none of jax,
flax, optax, h5py, tqdm, PIL or imageio. Here they are installed, so a
subprocess blocks them (``sys.modules[name] = None`` makes an import raise)
before it imports every module of the port and ``chip_smoke``, and reads an
HDF5 path and a PNG file, which must raise an ImportError that names h5py
and PIL. h5py, PIL and imageio may be imported inside a function (the
HDF5 and image readers and writers), never at module level.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "torch_em_tpu_torch"
BLOCKED = ("jax", "flax", "optax", "h5py", "tqdm", "PIL", "imageio", "torch_em_tpu")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import torch_em_tpu_torch
names = [m.name for m in pkgutil.walk_packages(torch_em_tpu_torch.__path__, "torch_em_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main)
from torch_em_tpu_torch.utils import io
try:
    io.load_data("data.h5", "raw")
except ImportError as e:
    assert "h5py" in str(e), e
else:
    raise AssertionError("reading HDF5 without h5py did not raise")
for read in (io.load_data, io.load_image):
    try:
        read("image.png")
    except ImportError as e:
        assert "PIL" in str(e), e
    else:
        raise AssertionError("reading a PNG without PIL did not raise")
print(len(names))
"""


def _port_sources():
    return sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_with_jax_stack_blocked():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 38


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax(path):
    text = path.read_text()
    assert "torch_em_tpu." not in text
    assert "import jax" not in text
    pattern = r"^\s*(from|import)\s+(jax|flax|optax|tqdm|torch_em_tpu)\b(?!_torch)"
    assert not re.search(pattern, text, flags=re.MULTILINE)
    # h5py, PIL and imageio only inside the functions that read or write HDF5 and images
    assert not re.search(r"^(from|import)\s+(h5py|PIL|imageio)\b", text, flags=re.MULTILINE)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card(where, tmp_path):
    """Without a CUDA device, or without the rest of the repository, the smoke run
    exits nonzero and prints no result line."""
    script = REPO / "chip_smoke.py"
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs in full here")
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
