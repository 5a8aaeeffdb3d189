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


# Row lengths of the main paths (chip_smoke.norm_shapes, unetr_norm_shapes) with their row counts:
# training on 32x256x256 patches, serving on (40, 576, 576) halo blocks (batch
# 1, rows = channels), and the DSB step.
TRAINING_ROWS = {2097152: (1, 32, 64), 524288: (32, 64, 128), 131072: (64, 128, 256),
                 16384: (128, 256, 512), 2048: (256, 512)}
SERVING_ROWS = {13271040: (1, 32, 64), 3317760: (32, 64, 128), 829440: (64, 128, 256),
                103680: (128, 256, 512), 12960: (256, 512)}
# the sharded paths (chip_smoke.py phase 15): a rank's slab of 64 planes with the derived halo of 2 x 36
# at 512x512 (halo_sharded_predict), and 48 planes with it at 256x256 (spatial_sharded_train_step). The
# decoder's first level-0 norm of a slab holds 64 x 35651584 elements, past 2**31.
HALO_SLAB_ROWS = {35651584: (1, 32, 64), 8912896: (32, 64, 128), 2228224: (64, 128, 256),
                  278528: (128, 256, 512), 34816: (256, 512)}
SPATIAL_SLAB_ROWS = {7864320: (1, 32, 64), 1966080: (32, 64, 128), 491520: (64, 128, 256),
                     61440: (128, 256, 512), 7680: (256, 512)}
# the DSB step (UNet2d f=64, depth 4, batch 8 of 256x256): rows are 8 x C
DSB_ROWS = {65536: (8, 512, 1024), 16384: (512, 1024), 4096: (1024, 2048), 1024: (2048, 4096),
            256: (4096, 8192)}
# the UNETR and ViM-UNet decoders' norms (the recipe's 512x512 input; ConvBlocks from 32x32 to
# 512x512): rows are C at serving batch 1 and 4 x C at training batch 4
UNETR_ROWS = {1024: (192, 512, 768, 768, 2048, 3072), 4096: (256, 512, 1024, 2048),
              16384: (128, 256, 512, 1024), 65536: (64, 128, 256, 512), 262144: (3, 64, 128, 12, 256, 512)}
# the self-training steps: UniMatch v2's student on both strong views of a DSB batch (batch 16, rows
# 16 x C of the DSB U-Net), and the Probabilistic U-Net's U-Net (widths 32/64/128/192, base 384) at
# batch 8 of 256x256
UNIMATCH_ROWS = {65536: (16, 1024, 2048), 16384: (1024, 2048, 4096), 4096: (2048, 4096, 8192),
                 1024: (4096, 8192, 16384), 256: (8192, 16384)}
PUNET_ROWS = {65536: (8, 256, 512), 16384: (256, 512, 1024), 4096: (512, 1024, 2048), 1024: (1024, 1536, 3072),
              256: (1536, 3072)}
# Shallow2DeepModel's enhancer (chip_smoke.py phase 16: UNet2d f=64, depth 4) on two 512x512 images at once:
# rows are 2 x C
S2D_PREDICT_ROWS = {262144: (2, 128, 256), 65536: (128, 256, 512), 16384: (256, 512, 1024), 4096: (512, 1024, 2048),
                    1024: (1024, 2048)}
# the MitoLab step (chip_smoke.py phase 17: UNet2d f=64, depth 4, batch 8 of 224x224): rows are 8 x C
MITOLAB_ROWS = {50176: (8, 512, 1024), 12544: (512, 1024, 2048), 3136: (1024, 2048, 4096), 784: (2048, 4096, 8192),
                196: (4096, 8192)}
# the last validation batch of the DSB recipe's 50 test images (chip_smoke.py phase 18): DSB_ROWS at batch 2
DSB_TEST_TAIL_ROWS = {length: tuple(r // 4 for r in rows) for length, rows in DSB_ROWS.items()}


def _decoder_rows(channels, skip, grid, size, batches, initial_features=64):
    """{row length: rows} of a UNETR decoder's norms (chip_smoke.unetr_norm_shapes) over an
    encoder grid of ``grid`` on a ``size`` input, the head at 16 x grid, at each batch."""
    feats = [initial_features * 2 ** i for i in range(4)][::-1]
    shapes = [(3, size), (feats[-1], size)] if skip else []
    shapes += [(channels, grid), (feats[0], grid)]
    for i, f in enumerate(feats[1:]):
        shapes += [(2 * f, grid * 2 ** (i + 1)), (f, grid * 2 ** (i + 1))]
    shapes += [(2 * feats[-1], 16 * grid), (feats[-1], 16 * grid)]
    rows = {}
    for c, side in shapes:
        rows.setdefault(side * side, set()).update(b * c for b in batches)
    return {length: tuple(sorted(r)) for length, r in rows.items()}


# the encoder families' UNETR decoders of chip_smoke.py phase 14, at serving batch 1 and their
# training batch: SAM2 hvit_b at 1024 without skips (d_model 256, grid 64), DINOv2 vit_b at 518
# (grid 37: rows of 1369, 5476 and 268324 elements, off the 16-byte grid), DINOv3 vit_b at 512,
# MAE vit_b at 224 (grid 14), ScaleMAE vit_l at 224 (its grid is 448 / 8 = 56; the head at 896)
# and SAM3 at 1008 (grid 72; the head's 1152x1152 rows take path C)
FAMILY_ROWS = {
    "sam2": _decoder_rows(256, False, 64, 1024, (1, 2)),
    "dinov2": _decoder_rows(768, True, 37, 518, (1, 4)),
    "dinov3": _decoder_rows(768, True, 32, 512, (1, 4)),
    "mae": _decoder_rows(768, True, 14, 224, (1, 4)),
    "scalemae": _decoder_rows(1024, True, 56, 224, (1, 4)),
    "sam3": _decoder_rows(1024, True, 72, 1008, (1, 2)),
}
# length -> path: A up to 16384 elements; B where the row's inputs fit 8
# blocks of shared memory; C beyond.
EXPECTED_PATH = {
    256: "A", 1024: "A", 2048: "A", 4096: "A", 12960: "A", 16384: "A", 65536: "B",
    103680: "B", 131072: "B", 262144: "B-but-float32-backward", 524288: "B-16-bit-forward",
    829440: "B-16-bit-forward", 2097152: "C", 3317760: "C", 13271040: "C",
    196: "A", 784: "A", 1369: "A", 3136: "A", 5184: "A", 5476: "A", 12544: "A", 20736: "B", 21904: "B",
    50176: "B", 82944: "B", 87616: "B", 200704: "B", 268324: "B-but-float32-backward",
    331776: "B-but-float32-backward", 350464: "B-but-float32-backward", 802816: "B-16-bit-forward",
    1016064: "C", 1048576: "C", 1327104: "C",
    35651584: "C", 8912896: "C", 2228224: "C", 278528: "B-but-float32-backward", 34816: "B",
    7864320: "C", 1966080: "C", 491520: "B-16-bit-forward", 61440: "B", 7680: "A",
}
SMEM_PER_BLOCK = 232448  # 227 KB, the most a Hopper block may use


def _expected_path(length, itemsize, direction):
    path = EXPECTED_PATH[length]
    if path == "B-16-bit-forward":  # only x of a 16-bit row of these lengths fits 8 x 225 KB
        return "B" if itemsize == 2 and direction == "forward" else "C"
    if path == "B-but-float32-backward":  # all but x and g of a float32 row fit 8 x 225 KB
        return "C" if itemsize == 4 and direction == "backward" else "B"
    return path


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("rows_of", [TRAINING_ROWS, SERVING_ROWS, DSB_ROWS, UNETR_ROWS, UNIMATCH_ROWS, PUNET_ROWS,
                                     *FAMILY_ROWS.values(), HALO_SLAB_ROWS, SPATIAL_SLAB_ROWS, S2D_PREDICT_ROWS,
                                     MITOLAB_ROWS, DSB_TEST_TAIL_ROWS],
                         ids=["training", "serving", "dsb", "unetr", "unimatch", "punet", *FAMILY_ROWS,
                              "halo_slab", "spatial_slab", "s2d_predict", "mitolab", "dsb_test_tail"])
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


# (batch, channels, side) of the self-training steps' norms, one per row length and width class:
# UniMatch v2's batch of 16 and the Probabilistic U-Net's 8 with its widths
SELF_TRAINING_SHAPES = [(16, 1, 256), (16, 64, 256), (16, 128, 128), (16, 512, 32), (16, 1024, 16),
                        (8, 32, 256), (8, 64, 128), (8, 192, 32), (8, 384, 16), (8, 384, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SELF_TRAINING_SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_kernels_at_self_training_shapes_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    batch, channels, side = case
    x = _card_inputs((batch, channels, side, side), dtype, 19)
    g = _card_inputs(x.shape, dtype, 20)
    ref = instance_norm_reference(x).float()
    assert bool(((instance_norm(x).float() - ref).abs() <= _output_tol(ref, dtype)).all())
    _, mean, rstd = instance_norm_forward_reference(x)
    _assert_dx_close(instance_norm_backward(x, g, mean, rstd),
                     instance_norm_backward_reference(x, g, mean, rstd), dtype)


# (batch, channels, side) of the encoder families' decoder norms (FAMILY_ROWS), one per row
# length and path, among them the lengths off the 16-byte grid and SAM3's path-C head rows
FAMILY_SHAPES = [(4, 768, 37), (4, 512, 74), (4, 256, 148), (4, 128, 296), (1, 3, 518), (4, 64, 592),
                 (4, 768, 14), (4, 128, 896), (2, 1024, 72), (2, 64, 1152), (1, 3, 1008), (2, 64, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FAMILY_SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_kernels_at_encoder_family_shapes_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    batch, channels, side = case
    x = _card_inputs((batch, channels, side, side), dtype, 21)
    g = _card_inputs(x.shape, dtype, 22)
    ref = instance_norm_reference(x).float()
    assert bool(((instance_norm(x).float() - ref).abs() <= _output_tol(ref, dtype)).all())
    _, mean, rstd = instance_norm_forward_reference(x)
    _assert_dx_close(instance_norm_backward(x, g, mean, rstd),
                     instance_norm_backward_reference(x, g, mean, rstd), dtype)
