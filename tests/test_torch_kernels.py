"""The instance-norm wrapper's dispatch and build, and the kernel on the card.

This file imports no JAX, so that the tests marked ``cuda`` run on a machine
with a card and without the JAX stack:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

import numpy as np
import pytest
import torch

from torch_em_tpu_torch.ops._build import load_library
from torch_em_tpu_torch.ops.instance_norm import (
    _instance_norm_cuda, instance_norm, instance_norm_reference,
)

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def test_cpu_tensor_takes_reference():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 3, 4, 5, 6)).astype(np.float32))
    before = instance_norm.launches
    assert torch.equal(instance_norm(x), instance_norm_reference(x))
    assert instance_norm.launches == before


def test_kernel_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        _instance_norm_cuda(torch.zeros(1, 1, 8), 1e-5)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr("torch_em_tpu_torch.ops._build.BUILD_DIR", tmp_path / "build")
    load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        load_library("tem_instance_norm", "instance_norm.cu")
    assert not (tmp_path / "build").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 11), (1, 1, 40, 72, 72), (1, 64, 3, 33, 33), (2, 5, 16)])
def test_kernel_matches_reference_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.from_numpy(np.random.default_rng(3).normal(size=shape).astype(np.float32))
    x = x.to("cuda", TORCH_DTYPE[dtype])
    before = instance_norm.launches
    y = instance_norm(x)
    torch.cuda.synchronize()
    assert instance_norm.launches == before + 1
    ref = instance_norm_reference(x).float()
    # float32: sums in another order; bfloat16: one rounding step of the output
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7 * ref.abs() + 1e-5
    assert bool(((y.float() - ref).abs() <= tol).all())
