"""The instance-norm wrappers' dispatch and build, and the kernels on the card.

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
    _instance_norm_backward_cuda, _instance_norm_cuda, instance_norm, instance_norm_backward,
    instance_norm_backward_reference, instance_norm_forward, instance_norm_forward_reference,
    instance_norm_reference,
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


def test_function_on_cpu_takes_references_and_counts_no_launches():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32))
    before = (instance_norm.launches, instance_norm_backward.launches)
    y = instance_norm(x)
    y.backward(g)
    assert (instance_norm.launches, instance_norm_backward.launches) == before
    y_ref, mean, rstd = instance_norm_forward_reference(x.detach())
    assert torch.equal(y.detach(), y_ref)
    assert torch.equal(x.grad, instance_norm_backward_reference(x.detach(), g, mean, rstd))


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 1, 8)
    stats = torch.zeros(1, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _instance_norm_backward_cuda(x, x, stats, stats)


def test_backward_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr("torch_em_tpu_torch.ops._build.BUILD_DIR", tmp_path / "build")
    load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        load_library("tem_instance_norm_bwd", "instance_norm_bwd.cu")
    assert not (tmp_path / "build").exists()


def _card_inputs(shape, dtype, seed, offset=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    flat = rng.normal(0.5, 2.0, size=n + offset).astype(np.float32)
    return torch.from_numpy(flat).to("cuda", TORCH_DTYPE[dtype])[offset:].view(shape)


def _assert_dx_close(dx, ref, dtype):
    # float32: sums in another order, atol 1e-4 of the largest |dx|;
    # bfloat16: one rounding step of the output
    ref = ref.float()
    scale = ref.abs().max()
    tol = 1e-4 * scale if dtype == "float32" else 2.0 ** -7 * ref.abs() + 1e-5 * scale
    assert bool(torch.isfinite(dx).all())
    assert bool(((dx.float() - ref).abs() <= tol).all())


BACKWARD_CASES = {
    "main_path": ((1, 32, 32, 64, 64), 0),
    "ragged": ((2, 3, 5, 7, 11), 0),
    "odd_length_multi_chunk": ((1, 1, 16384 * 3 + 5), 0),
    "misaligned": ((1, 2, 1000), 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BACKWARD_CASES))
def test_backward_kernel_matches_reference_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shape, offset = BACKWARD_CASES[case]
    x = _card_inputs(shape, dtype, 5, offset)
    g = _card_inputs(shape, dtype, 6, offset)
    _, mean, rstd = instance_norm_forward_reference(x)
    before = instance_norm_backward.launches
    dx = instance_norm_backward(x, g, mean, rstd)
    torch.cuda.synchronize()
    assert instance_norm_backward.launches == before + 1
    _assert_dx_close(dx, instance_norm_backward_reference(x, g, mean, rstd), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_takes_non_contiguous_gradient_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = _card_inputs((1, 4, 8, 32, 32), dtype, 7)
    g = _card_inputs((1, 8, 8, 32, 32), dtype, 8)[:, ::2]
    assert not g.is_contiguous()
    _, mean, rstd = instance_norm_forward_reference(x)
    dx = instance_norm_backward(x, g, mean, rstd)
    _assert_dx_close(dx, instance_norm_backward_reference(x, g, mean, rstd), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_on_card_matches_autograd_of_reference(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = _card_inputs((2, 16, 8, 24, 24), dtype, 9).requires_grad_()
    g = _card_inputs((2, 16, 8, 24, 24), dtype, 10)
    y, mean, rstd = instance_norm_forward(x.detach())
    y_ref, mean_ref, rstd_ref = instance_norm_forward_reference(x.detach())
    torch.testing.assert_close(mean, mean_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=0)
    before = (instance_norm.launches, instance_norm_backward.launches)
    instance_norm(x).backward(g)
    assert (instance_norm.launches, instance_norm_backward.launches) == (before[0] + 1, before[1] + 1)
    xr = x.detach().clone().requires_grad_()
    instance_norm_reference(xr).backward(g)
    _assert_dx_close(x.grad, xr.grad, dtype)


def test_function_passes_gradcheck_in_float64():
    """The Function's backward against finite differences of its forward (plain versions, float64)."""
    x = torch.from_numpy(np.random.default_rng(11).normal(size=(2, 3, 4, 5))).requires_grad_()
    assert torch.autograd.gradcheck(instance_norm, (x,))
