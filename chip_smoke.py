"""Smoke run of the PyTorch/CUDA port (torch_em_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit. Phases, each announced by a flushed ``[smoke +Ns] <phase>`` line:

1. device report (nvidia-smi name and power limit, torch and CUDA versions);
2. build the port's kernels with nvcc for sm_90a, one nvcc per source, all
   started together;
3. hold the forward instance-norm kernel against its plain PyTorch version
   on the card, in float32 and bfloat16, at every shape the serving path
   gives it plus ragged and misaligned shapes, and time kernel, plain
   version and the PyTorch library call at the serving path's shapes;
4. the serving path: the tracked CREMI AnisotropicUNet at full width, bf16
   compute, through ``predict_with_halo`` on a seeded 64x512x512 volume
   with block (32, 512, 512) and halo (4, 32, 32); checks the output, the
   kernel's launch count, and one block against the same model with the
   plain instance norm;
5. hold the backward instance-norm kernel against its plain version in
   float32 and bfloat16 at every shape the training path gives it plus
   ragged, odd-length, misaligned and non-contiguous-gradient cases, and
   time both kernels, their plain versions and the library calls at the
   training path's shapes;
6. the training path: ``default_segmentation_trainer`` on the tracked model
   at full width, bf16 compute, AdamW at lr 1e-4, 32x256x256 patches,
   batch 1, over ``SegmentationDataset``s of a seeded volume written as
   ``.npy`` files to a temporary directory; fits 32 iterations over 2
   epochs, rebuilds the trainer with ``DefaultTrainer.from_checkpoint`` and
   resumes for 8 more; checks iteration counts, a finite and falling loss,
   both kernels' launch counts and the checkpoints; then holds one float32
   training step's gradients with the kernels against the plain versions
   and times the step.

The last three lines are the card's name and power limit, a JSON line with
one entry per kernel, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or when any phase fails, it exits nonzero and prints no result line.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import unittest.mock
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

T0 = time.perf_counter()

TRACKED = dict(
    in_channels=1, out_channels=1, scale_factors=[[1, 2, 2], [1, 2, 2], [2, 2, 2], [2, 2, 2]],
    initial_features=32, final_activation="Sigmoid", anisotropic_kernel=True,
)
VOLUME_SHAPE = (64, 512, 512)
BLOCK_SHAPE = (32, 512, 512)
HALO = (4, 32, 32)
NORMS_PER_FORWARD = 18  # 9 ConvBlocks x 2 instance norms
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# kernel against plain version: float32 sums in another order; bfloat16 may
# differ by one rounding step of the output (2**-7 of its magnitude)
F32_ATOL = 1e-4
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
# one halo block through the model, kernel against plain norm: float32 with
# TF32 off; bf16 rounding flips of single norm outputs spread through convs
MODEL_F32_ATOL = 1e-4
MODEL_BF16_MAX, MODEL_BF16_MEAN = 2e-2, 1e-3
# backward kernel against plain version: float32 within 1e-4 of the largest
# |dx|; bfloat16 one rounding step of the output beside 1e-5 of the largest
BWD_F32_RTOL_OF_MAX = 1e-4
BWD_BF16_RTOL, BWD_BF16_RTOL_OF_MAX = 2.0 ** -7, 1e-5
# the training path
TRAIN_VOLUME = (48, 384, 384)
TRAIN_PATCH = (32, 256, 256)
TRAIN_SAMPLES, VAL_SAMPLES = 16, 2
FIT_ITERATIONS, RESUME_ITERATIONS = 32, 8
LEARNING_RATE = 1e-4
# one float32 training step (TF32 off), kernels against plain versions, both
# held against the same step in float64 with the plain versions. The float32
# gradients of this model are themselves inexact in the deep levels on either
# path (sums over millions of voxels with cancellation, and ReLU inputs that
# float32 rounding moves across zero), so the check is relative to the plain
# path: each parameter's gradient with the kernels must lie within 4x the
# plain version's L2 distance from the float64 gradient, plus 1e-5 of the
# model's largest |grad| per element (tensors whose true gradient is zero,
# such as the upsamplers' biases, which the next norm removes, hold only
# rounding noise). A wrongly wired or wrong backward moves a gradient by its
# own size, far beyond this.
GRAD_L2_FACTOR, GRAD_ATOL_OF_MODEL = 4.0, 1e-5


def log(msg):
    print(f"[smoke +{time.perf_counter() - T0:.1f}s] {msg}", flush=True)


def nvidia_smi():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def norm_shapes(block, scale_factors, initial_features, in_channels=1, gain=2):
    """(channels, spatial shape) of the instance norms of one U-Net forward, in order."""
    feats = [initial_features * gain ** i for i in range(len(scale_factors))]
    shapes, skips, sp, cin = [], [], tuple(block), in_channels
    for f, sf in zip(feats, scale_factors):
        shapes += [(cin, sp), (f, sp)]
        skips.append(sp)
        sp, cin = tuple(s // k for s, k in zip(sp, sf)), f
    shapes += [(cin, sp), (feats[-1] * gain, sp)]
    for f, skip in zip(feats[::-1], skips[::-1]):
        shapes += [(2 * f, skip), (f, skip)]
    return shapes


def time_ms(fn, *args, iters=5):
    """Mean device time of ``fn(*args)`` over ``iters`` calls, after one warm-up call."""
    fn(*args)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def card_rand(gen, shape, dtype, offset=0):
    """Seeded normal(0.5, 2) values on the card; ``offset`` elements shift the base address."""
    n = int(np.prod(shape))
    buf = (torch.randn(n + offset, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    return buf[offset:].view(shape)


def check_kernel(kernel, plain, x):
    """Max abs error of kernel against plain version; raises past the tolerance."""
    y = kernel(x).float()
    ref = plain(x).float()
    torch.cuda.synchronize()
    if x.dtype == torch.float32:
        tol = torch.full_like(ref, F32_ATOL)
    else:
        tol = BF16_RTOL * ref.abs() + BF16_ATOL
    err = (y - ref).abs()
    if not bool(torch.isfinite(y).all()) or bool((err > tol).any()):
        raise AssertionError(f"kernel disagrees at {tuple(x.shape)} {x.dtype}: "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def phase_norm_kernel(inorm, shapes):
    """Check and time the instance-norm kernel; returns its entry of the kernels line."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dtype, offset=0):
        return card_rand(g, shape, dtype, offset)

    max_err = 0.0
    ragged = [(2, 3, 5, 7, 11), (1, 1, inorm.CHUNK * 3 + 5), (1, 2, 40, 577, 577), (3, 4, 16)]
    for dtype in (torch.float32, torch.bfloat16):
        for c, sp in sorted(set(shapes)):
            err = check_kernel(inorm.instance_norm, inorm.instance_norm_reference,
                               rand((1, c) + sp, dtype))
            max_err = max(max_err, err)
            log(f"  norm {dtype} C={c} {sp}: max abs err {err:.3g}")
        for shape in ragged:
            max_err = max(max_err, check_kernel(inorm.instance_norm, inorm.instance_norm_reference,
                                                 rand(shape, dtype)))
        # a base address off the 16-byte grid takes the scalar path
        x = rand((1, 2, 1000), dtype, offset=1)
        assert x.data_ptr() % 16 != 0
        max_err = max(max_err, check_kernel(inorm.instance_norm, inorm.instance_norm_reference, x))
        log(f"  norm {dtype}: ragged and misaligned shapes agree")
    log(f"kernel agrees with instance_norm_reference: max abs err {max_err:.3g} "
        f"(f32 atol {F32_ATOL}; bf16 {BF16_RTOL:.3g}*|ref| + {BF16_ATOL})")

    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for c, sp in sorted(set(shapes)):
        x = rand((1, c) + sp, torch.bfloat16)
        count = shapes.count((c, sp))
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        ms = time_ms(inorm.instance_norm, x)
        plain = time_ms(inorm.instance_norm_reference, x)
        lib = time_ms(torch.nn.functional.instance_norm, x)
        log(f"  time bf16 C={c} {sp} x{count}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"F.instance_norm {lib:.4f} ms, bound {bound:.4f} ms")
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound), ("library_ms", lib)):
            totals[key] += count * v
        del x
    torch.cuda.empty_cache()
    log(f"per forward ({len(shapes)} norms, bf16): kernel {totals['ms']:.3f} ms, "
        f"plain {totals['plain_ms']:.3f} ms, F.instance_norm {totals['library_ms']:.3f} ms, "
        f"bound {totals['bound_ms']:.3f} ms")
    return {
        "name": "instance_norm",
        "route": "cuda",
        "source": "torch_em_tpu_torch/ops/csrc/instance_norm.cu",
        "replaces": "torch_em_tpu/ops/pallas/norm.py:83",
        "launches": None,
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes",
        "library_ms": totals["library_ms"],
    }


def phase_main_path(port, inorm, unet_module, n_expected_blocks):
    """Full-width tiled inference; returns the kernel launches of the checked run."""
    model = port.AnisotropicUNet(**TRACKED, dtype=torch.bfloat16, device="cuda", seed=0)
    volume = np.random.default_rng(0).random(VOLUME_SHAPE, dtype=np.float32)
    n_blocks = port.Blocking([0, 0, 0], VOLUME_SHAPE, BLOCK_SHAPE).n_blocks
    assert n_blocks == n_expected_blocks
    runs = []
    for run in range(2):  # the first run also pays for cuDNN's first calls
        inorm.instance_norm.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = port.predict_with_halo(volume, model, block_shape=BLOCK_SHAPE, halo=HALO,
                                     output_dtype="float16")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = inorm.instance_norm.launches
        runs.append((seconds, launches))
        if out.shape != (1,) + VOLUME_SHAPE:
            raise AssertionError(f"output shape {out.shape}")
        if not np.isfinite(out).all() or out.min() < 0 or out.max() > 1:
            raise AssertionError("output is not finite or leaves [0, 1]")
        if launches != NORMS_PER_FORWARD * n_blocks:
            raise AssertionError(f"{launches} kernel launches, expected "
                                 f"{NORMS_PER_FORWARD} x {n_blocks} blocks")
        log(f"run {run}: {seconds:.3f} s, {launches} kernel launches for {n_blocks} blocks, "
            f"output {out.shape} in [{out.min():.4f}, {out.max():.4f}]")
    seconds = runs[1][0]
    log(f"tiled inference: {np.prod(VOLUME_SHAPE) / seconds / 1e6:.2f} Mvox/s, "
        f"{seconds / n_blocks * 1e3:.1f} ms per block (host load + standardize + device + copy)")

    t = time.perf_counter()
    inp, _ = port.utils.prediction._load_block(volume, (0, 0, 0), BLOCK_SHAPE, HALO)
    inp = port.standardize(inp)
    host_ms = (time.perf_counter() - t) * 1e3
    x = torch.from_numpy(inp[None, None]).cuda()
    with torch.inference_mode():
        fwd_ms = time_ms(model, x, iters=3)
        torch.cuda.reset_peak_memory_stats()
        y_kernel = model(x)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with unittest.mock.patch.object(unet_module, "instance_norm", inorm.instance_norm_reference):
            y_plain = model(x)
    log(f"one halo block {tuple(x.shape)}: host load + standardize {host_ms:.1f} ms, "
        f"model forward {fwd_ms:.2f} ms on the device, peak memory {peak:.2f} GiB")
    diff = (y_kernel - y_plain).abs()
    log(f"bf16 block, kernel vs plain norm: max abs diff {float(diff.max()):.3g}, "
        f"mean {float(diff.mean()):.3g} (limits {MODEL_BF16_MAX}, {MODEL_BF16_MEAN})")
    if float(diff.max()) > MODEL_BF16_MAX or float(diff.mean()) > MODEL_BF16_MEAN:
        raise AssertionError("bf16 model with the kernel disagrees with the plain norm")

    model32 = port.AnisotropicUNet(**TRACKED, dtype=torch.float32, device="cuda", seed=0)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            y_kernel = model32(x)
            with unittest.mock.patch.object(unet_module, "instance_norm",
                                            inorm.instance_norm_reference):
                y_plain = model32(x)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = float((y_kernel - y_plain).abs().max())
    log(f"f32 block (TF32 off), kernel vs plain norm: max abs diff {err:.3g} "
        f"(limit {MODEL_F32_ATOL})")
    if err > MODEL_F32_ATOL:
        raise AssertionError("f32 model with the kernel disagrees with the plain norm")
    return runs[0][1]


def check_backward(inorm, x, g):
    """Max abs error of the backward kernel against its plain version; raises past the tolerance."""
    _, mean, rstd = inorm.instance_norm_forward_reference(x)
    dx = inorm.instance_norm_backward(x, g, mean, rstd).float()
    ref = inorm.instance_norm_backward_reference(x, g, mean, rstd).float()
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    if x.dtype == torch.float32:
        tol = torch.full_like(ref, BWD_F32_RTOL_OF_MAX * scale)
    else:
        tol = BWD_BF16_RTOL * ref.abs() + BWD_BF16_RTOL_OF_MAX * scale
    err = (dx - ref).abs()
    if not bool(torch.isfinite(dx).all()) or bool((err > tol).any()):
        raise AssertionError(f"backward kernel disagrees at {tuple(x.shape)} {x.dtype}: "
                             f"max abs err {float(err.max())} (max |dx| {scale})")
    return float(err.max())


def phase_backward_kernel(inorm, shapes):
    """Check the backward kernel and time both kernels at the training path's shapes.

    Returns the backward kernel's entry of the kernels line, with times summed
    over the norms whose backward one training step runs: all but the first,
    whose input is the raw patch, which needs no gradient."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    F = torch.nn.functional
    max_err = 0.0
    ragged = [(2, 3, 5, 7, 11), (1, 1, inorm.CHUNK * 3 + 5), (1, 2, 33, 257, 257), (3, 4, 16)]
    for dtype in (torch.float32, torch.bfloat16):
        for c, sp in sorted(set(shapes)):
            shape = (1, c) + sp
            err = check_backward(inorm, card_rand(gen, shape, dtype), card_rand(gen, shape, dtype))
            max_err = max(max_err, err)
            log(f"  backward {dtype} C={c} {sp}: max abs err {err:.3g}")
        for shape in ragged:
            max_err = max(max_err, check_backward(inorm, card_rand(gen, shape, dtype),
                                                  card_rand(gen, shape, dtype)))
        # base addresses off the 16-byte grid take the scalar path
        x, g = card_rand(gen, (1, 2, 1000), dtype, offset=1), card_rand(gen, (1, 2, 1000), dtype, offset=3)
        assert x.data_ptr() % 16 != 0 and g.data_ptr() % 16 != 0
        max_err = max(max_err, check_backward(inorm, x, g))
        # autograd may hand over a non-contiguous gradient; the wrapper copies it
        g = card_rand(gen, (1, 64, 8, 64, 64), dtype)[:, ::2]
        assert not g.is_contiguous()
        max_err = max(max_err, check_backward(inorm, card_rand(gen, g.shape, dtype), g))
        log(f"  backward {dtype}: ragged, odd-length, misaligned and non-contiguous cases agree")
    log(f"backward kernel agrees with instance_norm_backward_reference: max abs err {max_err:.3g} "
        f"(f32 {BWD_F32_RTOL_OF_MAX}*max|dx|; bf16 {BWD_BF16_RTOL:.3g}*|ref| + "
        f"{BWD_BF16_RTOL_OF_MAX}*max|dx|)")

    step_shapes = shapes[1:]
    fwd = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    bwd = dict(fwd)
    for c, sp in sorted(set(shapes)):
        x = card_rand(gen, (1, c) + sp, torch.bfloat16)
        g = card_rand(gen, (1, c) + sp, torch.bfloat16)
        size = x.numel() * x.element_size()
        _, mean, rstd = inorm.instance_norm_forward_reference(x)
        f_ms = time_ms(inorm.instance_norm_forward, x)
        f_plain = time_ms(inorm.instance_norm_forward_reference, x)
        f_lib = time_ms(F.instance_norm, x)
        f_bound = 2 * size / HBM_BYTES_PER_S * 1e3
        b_ms = time_ms(inorm.instance_norm_backward, x, g, mean, rstd)
        b_plain = time_ms(inorm.instance_norm_backward_reference, x, g, mean, rstd)
        xr = x.detach().requires_grad_()
        yr = F.instance_norm(xr)
        b_lib = time_ms(lambda: torch.autograd.grad(yr, xr, g, retain_graph=True))
        b_bound = 3 * size / HBM_BYTES_PER_S * 1e3
        n_fwd, n_bwd = shapes.count((c, sp)), step_shapes.count((c, sp))
        log(f"  time bf16 C={c} {sp} fwd x{n_fwd}: kernel {f_ms:.4f} ms, plain {f_plain:.4f} ms, "
            f"F.instance_norm {f_lib:.4f} ms, bound {f_bound:.4f} ms; bwd x{n_bwd}: kernel "
            f"{b_ms:.4f} ms, plain {b_plain:.4f} ms, F.instance_norm backward {b_lib:.4f} ms, "
            f"bound {b_bound:.4f} ms")
        for key, v in (("ms", f_ms), ("plain_ms", f_plain), ("bound_ms", f_bound), ("library_ms", f_lib)):
            fwd[key] += n_fwd * v
        for key, v in (("ms", b_ms), ("plain_ms", b_plain), ("bound_ms", b_bound), ("library_ms", b_lib)):
            bwd[key] += n_bwd * v
        del x, g, xr, yr
    torch.cuda.empty_cache()
    log(f"per training step, forward ({len(shapes)} norms, bf16): kernel {fwd['ms']:.3f} ms, "
        f"plain {fwd['plain_ms']:.3f} ms, F.instance_norm {fwd['library_ms']:.3f} ms, "
        f"bound {fwd['bound_ms']:.3f} ms")
    log(f"per training step, backward ({len(step_shapes)} norms, bf16): kernel {bwd['ms']:.3f} ms, "
        f"plain {bwd['plain_ms']:.3f} ms, F.instance_norm backward {bwd['library_ms']:.3f} ms, "
        f"bound {bwd['bound_ms']:.3f} ms")
    return {
        "name": "instance_norm_backward",
        "route": "cuda",
        "source": "torch_em_tpu_torch/ops/csrc/instance_norm_bwd.cu",
        "replaces": "torch_em_tpu/ops/pallas/norm.py:94",
        "launches": None,
        "max_abs_err": max_err,
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": "bytes",
        "library_ms": bwd["library_ms"],
    }


def training_volume(seed=0):
    """A seeded raw volume and a learnable target derived from it: raw is smoothed
    noise, the target a threshold of raw smoothed once more."""
    from scipy import ndimage

    noise = np.random.default_rng(seed).normal(size=TRAIN_VOLUME).astype(np.float32)
    raw = ndimage.gaussian_filter(noise, 1.0)
    raw = (raw - raw.mean()) / raw.std()
    labels = (ndimage.gaussian_filter(raw, 2.0) > 0).astype(np.float32)
    return raw, labels


class LossLog:
    """Trainer logger that keeps the training losses and validation metrics."""

    def __init__(self, trainer, save_root, **kwargs):
        self.losses, self.metrics = [], []

    def log_train(self, step, loss, lr, x, y, prediction, log_gradients=False):
        self.losses.append(loss)

    def log_validation(self, step, metric, loss, x, y, prediction):
        self.metrics.append(metric)


def phase_training(port, inorm):
    """The training path; returns the forward and backward kernel launches of its run."""
    raw, labels = training_volume()
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "raw.npy"), raw)
        np.save(os.path.join(tmp, "labels.npy"), labels)
        del raw, labels

        def loader(n_samples, shuffle):
            ds = port.SegmentationDataset(
                os.path.join(tmp, "raw.npy"), None, os.path.join(tmp, "labels.npy"), None,
                patch_shape=TRAIN_PATCH, n_samples=n_samples, raw_transform=port.standardize)
            return port.DataLoader(ds, batch_size=1, shuffle=shuffle, num_workers=4)

        np.random.seed(0)
        model = port.AnisotropicUNet(**TRACKED, device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "smoke", model, loader(TRAIN_SAMPLES, True), loader(VAL_SAMPLES, False),
            learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True, logger=LossLog,
            save_root=tmp)
        folder = trainer.checkpoint_folder

        inorm.instance_norm.launches = 0
        inorm.instance_norm_backward.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.fit(iterations=FIT_ITERATIONS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        resumed = port.DefaultTrainer.from_checkpoint(folder, "latest")
        if resumed.iteration != FIT_ITERATIONS:
            raise AssertionError(f"from_checkpoint restored iteration {resumed.iteration}")
        resumed.fit(iterations=RESUME_ITERATIONS)
        torch.cuda.synchronize()
        launches = (inorm.instance_norm.launches, inorm.instance_norm_backward.launches)

        steps = FIT_ITERATIONS + RESUME_ITERATIONS
        validations = len(trainer.logger.metrics) + len(resumed.logger.metrics)
        if trainer.iteration != FIT_ITERATIONS or trainer.epoch != 2 or resumed.iteration != steps:
            raise AssertionError(f"iterations {trainer.iteration}, epochs {trainer.epoch}, "
                                 f"resumed {resumed.iteration}")
        expected = (NORMS_PER_FORWARD * (steps + VAL_SAMPLES * validations),
                    (NORMS_PER_FORWARD - 1) * steps)
        log(f"training launches: forward {launches[0]}, backward {launches[1]} for {steps} steps "
            f"and {validations} validations of {VAL_SAMPLES} patches (expected {expected})")
        if launches != expected:
            raise AssertionError(f"kernel launches {launches}, expected {expected}")
        losses = trainer.logger.losses + resumed.logger.losses
        first, last = float(np.mean(losses[:4])), float(np.mean(losses[FIT_ITERATIONS - 4:FIT_ITERATIONS]))
        log(f"loss over {len(losses)} steps: first four {first:.4f}, last four of the first fit "
            f"{last:.4f}, last {losses[-1]:.4f}; validation metrics "
            f"{[round(m, 4) for m in trainer.logger.metrics + resumed.logger.metrics]}")
        if len(losses) != steps or not np.all(np.isfinite(losses)) or not last < first:
            raise AssertionError("the training loss is not finite or does not fall")
        saved = sorted(os.listdir(folder))
        if not {"best.ckpt", "latest.ckpt"} <= set(saved):
            raise AssertionError(f"checkpoints {saved}")
        log(f"fit {FIT_ITERATIONS} iterations in {fit_s:.2f} s wall ({fit_s / FIT_ITERATIONS * 1e3:.1f} "
            f"ms per iteration with data loading, 2 validations and checkpoints, "
            f"{FIT_ITERATIONS / fit_s:.2f} patches/s); checkpoints {saved}")

        # one training step on a device-resident batch
        x, y = (v.cuda() for v in next(iter(resumed.train_loader)))
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(resumed._train_step, x, y, iters=10)
        t = time.perf_counter()
        for _ in range(10):
            resumed._train_step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) / 10 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"training step {tuple(x.shape)} bf16: {step_ms:.2f} ms device (CUDA events), "
            f"{wall_ms:.2f} ms wall, {1e3 / wall_ms:.2f} patches/s, peak memory {peak:.2f} GiB; "
            f"{nvidia_smi()}")
        del trainer, resumed, model
    torch.cuda.empty_cache()
    check_training_gradients(port, inorm, x, y)
    return launches


def check_training_gradients(port, inorm, x, y):
    """One float32 training step (TF32 off): the kernels against the plain versions,
    each against the same step in float64."""
    model = port.AnisotropicUNet(**TRACKED, dtype=torch.float32, device="cuda", seed=1)

    def grads(net, xb, yb):
        net.zero_grad(set_to_none=True)
        port.DiceLoss()(net(xb), yb).backward()
        return {n: p.grad.clone() for n, p in net.named_parameters()}

    plain_norm = (unittest.mock.patch.object(inorm, "instance_norm_forward",
                                             inorm.instance_norm_forward_reference),
                  unittest.mock.patch.object(inorm, "instance_norm_backward",
                                             inorm.instance_norm_backward_reference))
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kernel = grads(model, x, y)
        with plain_norm[0], plain_norm[1]:
            plain = grads(model, x, y)
            model.double()
            model.dtype = torch.float64
            exact = grads(model, x.double(), y.double())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    largest = max(float(g.abs().max()) for g in exact.values())
    rows = []
    for name, ref in exact.items():
        dist_kernel = float((kernel[name].double() - ref).norm())
        dist_plain = float((plain[name].double() - ref).norm())
        tol = GRAD_L2_FACTOR * dist_plain + GRAD_ATOL_OF_MODEL * largest * ref.numel() ** 0.5
        size = max(float(ref.norm()), 1e-30)
        rows.append((dist_kernel / tol, name, dist_kernel / size, dist_plain / size,
                     float((kernel[name] - plain[name]).norm()) / size))
        if not bool(torch.isfinite(kernel[name]).all()) or dist_kernel > tol:
            raise AssertionError(f"gradient of {name} with the kernels is {dist_kernel:.3g} (L2) from "
                                 f"float64, the plain version's {dist_plain:.3g} (tolerance {tol:.3g})")
    for ratio, name, rel_kernel, rel_plain, rel_diff in sorted(rows, reverse=True)[:3]:
        log(f"  {name}: L2 distance from float64 {rel_kernel:.3g} (kernels), {rel_plain:.3g} (plain) "
            f"of its norm; kernels vs plain {rel_diff:.3g}; {ratio:.3g} of its tolerance")
    log(f"f32 training step (TF32 off): all {len(exact)} gradients with the kernels within "
        f"{GRAD_L2_FACTOR}x the plain version's L2 distance from float64 + "
        f"{GRAD_ATOL_OF_MODEL}*max|grad| per element (max|grad| {largest:.3g}); largest relative "
        f"distance from float64: kernels {max(r[2] for r in rows if r[3] < 1):.3g}, plain "
        f"{max(r[3] for r in rows if r[3] < 1):.3g}")


def main():
    log("start")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs one NVIDIA card",
              file=sys.stderr, flush=True)
        return 2
    try:
        import torch_em_tpu_torch as port
        import torch_em_tpu_torch.models.unet as unet_module
        import torch_em_tpu_torch.ops.instance_norm as inorm

        log("phase 1: device")
        smi = nvidia_smi()
        name = torch.cuda.get_device_name(0)
        log(f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s), device 0 {name}")

        log("phase 2: build kernels")
        t = time.perf_counter()
        with ThreadPoolExecutor(max_workers=2) as pool:
            builds = [pool.submit(inorm.load_kernel), pool.submit(inorm.load_backward_kernel)]
            for build in builds:
                build.result()
        log(f"built instance_norm.cu and instance_norm_bwd.cu in {time.perf_counter() - t:.1f} s")

        log("phase 3: forward kernel against its plain version, serving shapes")
        block = tuple(b + 2 * h for b, h in zip(BLOCK_SHAPE, HALO))
        shapes = norm_shapes(block, TRACKED["scale_factors"], TRACKED["initial_features"])
        assert len(shapes) == NORMS_PER_FORWARD
        forward = phase_norm_kernel(inorm, shapes)

        log("phase 4: serving path, tiled AnisotropicUNet inference")
        n_blocks = int(np.prod([-(-v // b) for v, b in zip(VOLUME_SHAPE, BLOCK_SHAPE)]))
        serving_launches = phase_main_path(port, inorm, unet_module, n_blocks)

        log("phase 5: backward kernel against its plain version, training shapes")
        train_shapes = norm_shapes(TRAIN_PATCH, TRACKED["scale_factors"], TRACKED["initial_features"])
        backward = phase_backward_kernel(inorm, train_shapes)

        log("phase 6: training path, default_segmentation_trainer on the tracked model")
        train_fwd, train_bwd = phase_training(port, inorm)
        forward["launches"] = serving_launches + train_fwd
        backward["launches"] = train_bwd
        log(f"forward kernel launches: {serving_launches} serving + {train_fwd} training; "
            f"backward kernel launches: {train_bwd} training")
    except Exception:
        traceback.print_exc()
        log("FAILED")
        return 1

    print(smi, flush=True)
    print(json.dumps({"kernels": [forward, backward]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
