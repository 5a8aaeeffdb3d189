"""The instance-norm wrappers' dispatch and build, and the kernels on the card.

This file imports no JAX, so that the tests marked ``cuda`` run on a machine
with a card and without the JAX stack:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

import numpy as np
import pytest
import torch

import torch_em_tpu_torch.ops.instance_norm as inorm
from torch_em_tpu_torch.ops._build import load_library
from torch_em_tpu_torch.ops.instance_norm import (
    _instance_norm_backward_cuda, _instance_norm_cuda, instance_norm, instance_norm_backward,
    instance_norm_backward_reference, instance_norm_forward, instance_norm_forward_reference,
    instance_norm_reference, plan,
)

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
DTYPES = sorted(TORCH_DTYPE)


def _output_tol(ref, dtype):
    """float32: sums in another order, atol 1e-4; bfloat16: one rounding step of the
    output, 2**-7 * |y| + 1e-5; float16: one rounding step, 2**-10 * |y| + 1e-5 of the
    largest |y|."""
    if dtype == "float32":
        return 1e-4
    if dtype == "bfloat16":
        return 2.0 ** -7 * ref.abs() + 1e-5
    return 2.0 ** -10 * ref.abs() + 1e-5 * ref.abs().max()


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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 11), (1, 1, 40, 72, 72), (1, 64, 3, 33, 33), (2, 5, 16),
                                   (1, 8, 32, 64, 64), (1, 2, 32, 256, 256)])
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
    assert bool(((y.float() - ref).abs() <= _output_tol(ref, dtype)).all())


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
    # bfloat16 and float16: one rounding step of the output
    ref = ref.float()
    scale = ref.abs().max()
    step = {"float32": None, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}[dtype]
    tol = 1e-4 * scale if step is None else step * ref.abs() + 1e-5 * scale
    assert bool(torch.isfinite(dx).all())
    assert bool(((dx.float() - ref).abs() <= tol).all())


BACKWARD_CASES = {
    "main_path": ((1, 32, 32, 64, 64), 0),
    "ragged": ((2, 3, 5, 7, 11), 0),
    "odd_length_multi_chunk": ((1, 1, 16384 * 3 + 5), 0),
    "misaligned": ((1, 2, 1000), 1),
    "large_rows": ((1, 2, 32, 256, 256), 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
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
@pytest.mark.parametrize("dtype", DTYPES)
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
@pytest.mark.parametrize("dtype", DTYPES)
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


# Row lengths of the main paths (chip_smoke.norm_shapes) with their row counts:
# training on 32x256x256 patches, serving on (40, 576, 576) halo blocks (batch
# 1, rows = channels), and the DSB step.
TRAINING_ROWS = {2097152: (1, 32, 64), 524288: (32, 64, 128), 131072: (64, 128, 256),
                 16384: (128, 256, 512), 2048: (256, 512)}
SERVING_ROWS = {13271040: (1, 32, 64), 3317760: (32, 64, 128), 829440: (64, 128, 256),
                103680: (128, 256, 512), 12960: (256, 512)}
# the DSB step (UNet2d f=64, depth 4, batch 8 of 256x256): rows are 8 x C
DSB_ROWS = {65536: (8, 512, 1024), 16384: (512, 1024), 4096: (1024, 2048), 1024: (2048, 4096),
            256: (4096, 8192)}
# length -> path: A up to 16384 elements; B where the row's inputs fit 8
# blocks of shared memory; C beyond.
EXPECTED_PATH = {
    256: "A", 1024: "A", 2048: "A", 4096: "A", 12960: "A", 16384: "A", 65536: "B",
    103680: "B", 131072: "B", 524288: "B-16-bit-forward", 829440: "B-16-bit-forward",
    2097152: "C", 3317760: "C", 13271040: "C",
}
SMEM_PER_BLOCK = 232448  # 227 KB, the most a Hopper block may use


def _expected_path(length, itemsize, direction):
    path = EXPECTED_PATH[length]
    if path == "B-16-bit-forward":  # only x of a 16-bit row of these lengths fits 8 x 225 KB
        return "B" if itemsize == 2 and direction == "forward" else "C"
    return path


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("rows_of", [TRAINING_ROWS, SERVING_ROWS, DSB_ROWS], ids=["training", "serving", "dsb"])
def test_plan_at_main_path_shapes(rows_of, itemsize, direction):
    inputs = 1 if direction == "forward" else 2
    width = 16 // itemsize
    for length, channels in rows_of.items():
        for rows in channels:
            p = plan(rows, length, itemsize, direction)
            assert p.path == _expected_path(length, itemsize, direction), (length, rows, p)
            assert p.threads % 32 == 0 and p.smem + 1024 <= SMEM_PER_BLOCK
            assert p.cluster * p.span >= length
            if p.path == "A":
                assert (p.blocks, p.cluster, p.smem) == (rows, 1, 0)
                assert p.threads <= 512 and p.threads * 32 >= length
            elif p.path == "B":
                assert p.blocks == rows * p.cluster and p.cluster in (1, 2, 4, 8)
                assert p.threads == 1024 and p.span % width == 0
                assert inputs * p.span * itemsize == p.smem  # the whole slice stays resident
            else:
                assert p.threads == 512 and p.span % width == 0
                assert p.blocks == p.cluster * p.in_flight <= 2 * 132  # all resident
                assert p.in_flight == 1 or p.in_flight * inputs * length * itemsize <= 24 * 2 ** 20
                if rows == 1:  # the raw input's one row spreads over every SM
                    assert p.blocks == 2 * 132


def test_inference_runs_the_forward_alone_and_counts_the_launch(monkeypatch):
    """Under inference_mode the wrapper skips the autograd Function and allocates
    no statistics; the card call is mocked on a meta tensor."""
    calls = []

    def fake_launch(fn, device, *args):
        calls.append(args)
        return 0

    monkeypatch.setattr(inorm, "_launch", fake_launch)
    monkeypatch.setattr(inorm, "_check_input", lambda x, what: None)
    monkeypatch.setattr(inorm, "_sm_count", lambda index: 132)
    monkeypatch.setattr(inorm, "load_kernel", lambda: None)
    x = torch.empty(1, 4, 8, 16, 16, device="meta", requires_grad=True)
    before = instance_norm.launches
    with torch.inference_mode():
        y = instance_norm(x)
    assert instance_norm.launches == before + 1
    assert y.grad_fn is None and y.shape == x.shape
    assert calls[0][2] is None and calls[0][3] is None  # mean, rstd: none allocated
    y = instance_norm(x)
    assert instance_norm.launches == before + 2
    assert calls[1][2] is not None and calls[1][3] is not None
    assert len(y.grad_fn.saved_tensors) == 3  # x, mean, rstd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["strided", "channels_last"])
def test_kernels_take_any_layout_on_card(layout, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if layout == "strided":
        x = _card_inputs((1, 8, 8, 32, 32), dtype, 12)[:, ::2]
    else:
        x = _card_inputs((1, 4, 8, 32, 32), dtype, 12).to(memory_format=torch.channels_last_3d)
    g = _card_inputs(x.shape, dtype, 13)
    assert not x.is_contiguous()
    ref = instance_norm_reference(x).float()
    y = instance_norm(x)
    assert bool(((y.float() - ref).abs() <= _output_tol(ref, dtype)).all())
    _, mean, rstd = instance_norm_forward_reference(x)
    _assert_dx_close(instance_norm_backward(x, g, mean, rstd),
                     instance_norm_backward_reference(x, g, mean, rstd), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 8, 16, 32, 32), (1, 8, 32, 64, 64), (1, 2, 32, 256, 256)],
                         ids=["A", "B", "C"])
def test_kernels_are_bitwise_repeatable_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, g = _card_inputs(shape, dtype, 14), _card_inputs(shape, dtype, 15)
    y1, mean1, rstd1 = instance_norm_forward(x)
    y2, mean2, rstd2 = instance_norm_forward(x)
    assert torch.equal(y1, y2) and torch.equal(mean1, mean2) and torch.equal(rstd1, rstd2)
    assert torch.equal(instance_norm_backward(x, g, mean1, rstd1),
                       instance_norm_backward(x, g, mean1, rstd1))


@pytest.mark.cuda
def test_second_derivative_on_card_matches_reference():
    """create_graph=True takes the plain differentiable dx; a first-order backward still
    launches the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x0 = _card_inputs((1, 4, 8, 16, 16), "float32", 16)
    g, v = _card_inputs(x0.shape, "float32", 17), _card_inputs(x0.shape, "float32", 18)

    def second(fn):
        x = x0.clone().requires_grad_()
        (dx,) = torch.autograd.grad(fn(x), x, g, create_graph=True)
        return torch.autograd.grad(dx, x, v)[0]

    before = instance_norm_backward.launches
    got, ref = second(instance_norm), second(instance_norm_reference)
    assert instance_norm_backward.launches == before
    assert bool(((got - ref).abs() <= 1e-4 * ref.abs().max()).all())
    x = x0.clone().requires_grad_()
    instance_norm(x).backward(g)
    assert instance_norm_backward.launches == before + 1
