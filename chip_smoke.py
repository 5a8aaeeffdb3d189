"""Smoke run of the PyTorch/CUDA port (torch_em_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit. Phases, each announced by a flushed ``[smoke +Ns] <phase>`` line:

1. device report (nvidia-smi name and power limit, torch and CUDA versions);
2. build the port's kernels with nvcc for sm_90a, one nvcc per source, all
   started together;
3. hold the forward instance-norm kernel against its plain PyTorch version
   on the card, in float32, bfloat16 and float16, at every shape the
   serving and training paths give it, plus ragged, misaligned, strided and
   channels-last inputs and a bitwise repeat on each kernel path (A, B, C:
   ``ops/instance_norm.py:plan``); time kernel (as called, and device-only
   from a CUDA graph of 20 calls), plain version and the PyTorch library
   call at the serving path's shapes;
4. the serving path: the tracked CREMI AnisotropicUNet at full width, bf16
   compute, through ``predict_with_halo`` with block (32, 512, 512) and halo
   (4, 32, 32) on two seeded volumes, the tracked 64x512x512 (2 blocks) and
   128x1024x1024 (16 blocks), each through the pipelined host path (a numpy
   volume) and the device-resident path (a tensor on the card); after a
   warm-up call, times each call (Mvox/s, ms per block, the forwards' device
   time by CUDA events and the device's idle share over the call) and checks
   the norm kernel's launches, the outputs' shape and range, the two paths
   against each other and the host path against a plain serial block loop
   with host ``standardize``; then one block against the same model with the
   plain instance norm, and a profiler breakdown of one block's forward;
5. the same for the backward instance-norm kernel (plus a non-contiguous
   gradient), and time both kernels, their plain versions and the library
   calls at the training path's shapes;
6. the training path: ``default_segmentation_trainer`` on the tracked model
   at full width, bf16 compute, AdamW at lr 1e-4, 32x256x256 patches,
   batch 1, over ``SegmentationDataset``s of a seeded raw volume and its
   instance labels (connected components of a threshold) written as
   ``.npy`` files to a temporary directory, with the affinity target of
   ``DeviceAffinityTransform`` computed inside the step; fits 32 iterations
   over 2 epochs, rebuilds the trainer with ``DefaultTrainer.from_checkpoint``
   (the transform included) and resumes for 8 more; checks iteration
   counts, a finite and falling loss, both kernels' launch counts and the
   checkpoints; holds the device affinity and boundary transforms against
   the host ones on label patches; times the loader with the host
   ``AffinityTransform`` and with the device transform in the step, the
   bare step, and breaks one down with the profiler; then holds one float32
   training step's gradients with the kernels against the plain versions;
7. the 3-D recipe through the factory: ``default_segmentation_loader`` over
   two seeded ``.npy`` volumes (a ``ConcatDataset`` with the default
   anisotropic flips and ``standardize``) trains the tracked model with
   ``DeviceAffinityTransform`` in the step for 16 iterations, then 4 more
   after ``from_checkpoint``; times the loader feeding steps with no
   transform, with the default flips and with flips and
   ``RandomElasticDeformation3D`` on the host;
8. ``AugmentationPipeline.apply_batched``: every registry entry's apply on
   the card and on the CPU with the same parameters, at batch 1 and 4 of
   32x256x256 patches (the 2-D entries take the 32 planes as channels):
   floats within 1e-5 of the input's range, labels equal but near rounding
   ties; times each entry per batch on the card and per sample on the host;
9. the DSB recipe: ``default_segmentation_loader`` over 16 seeded 2-D
   ``.npy`` images of 200-360 pixels a side (the file list and the
   folder-glob form give equal samples), ``BoundaryTransform`` targets,
   ``UNet2d(1, 2, initial_features=64, Sigmoid)`` in bf16 at batch 8 of
   256x256, 16 iterations and 4 more after ``from_checkpoint``; times the
   loader and the bare step; then ``train_2d_unet`` and
   ``predict_with_tiling`` in subprocesses.

Phases 3 and 5 also hold both kernels at the DSB step's shapes (batch 8,
rows 8 x C from 8 x 1 to 8 x 1024, 65536 down to 256 elements), and phase 5
times them there.

The last three lines are the card's name and power limit, a JSON line with
one entry per kernel, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or when any phase fails, it exits nonzero and prints no result line.
"""

import json
import os
import re
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
# the tracked volume, and one of 16 blocks (512 MiB of float32) for the pipeline to overlap
SERVING_VOLUMES = (VOLUME_SHAPE, (128, 1024, 1024))
BLOCK_SHAPE = (32, 512, 512)
HALO = (4, 32, 32)
NORMS_PER_FORWARD = 18  # 9 ConvBlocks x 2 instance norms
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# kernel against plain version: float32 sums in another order; bfloat16 may
# differ by one rounding step of the output (2**-7 of its magnitude); float16
# by one step (2**-10 of its magnitude) beside 1e-5 of the largest value
F32_ATOL = 1e-4
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
F16_RTOL, F16_RTOL_OF_MAX = 2.0 ** -10, 1e-5
# one halo block through the model, kernel against plain norm: float32 with
# TF32 off; bf16 rounding flips of single norm outputs spread through convs
MODEL_F32_ATOL = 1e-4
MODEL_BF16_MAX, MODEL_BF16_MEAN = 2e-2, 1e-3
# backward kernel against plain version: float32 within 1e-4 of the largest
# |dx|; bfloat16 and float16 one rounding step of the output beside 1e-5 of
# the largest
BWD_F32_RTOL_OF_MAX = 1e-4
BWD_BF16_RTOL, BWD_BF16_RTOL_OF_MAX = 2.0 ** -7, 1e-5
BWD_F16_RTOL = 2.0 ** -10
# device-only time: calls captured in one CUDA graph
GRAPH_CALLS = 20
# the training path
TRAIN_VOLUME = (48, 384, 384)
TRAIN_PATCH = (32, 256, 256)
TRAIN_SAMPLES, VAL_SAMPLES = 16, 2
FIT_ITERATIONS, RESUME_ITERATIONS = 32, 8
LEARNING_RATE = 1e-4
# the tracked benchmark's affinity offset (one output channel)
OFFSETS = [[-1, 0, 0]]
LOADER_THREADS, LOADER_STEPS = 4, 8
# the 3-D recipe through the factory (phase 7): two volumes, 16 iterations, 4 more after the resume
RECIPE_FIT, RECIPE_RESUME = 16, 4
FLIPS_3D = ["RandomHorizontalFlip3D", "RandomVerticalFlip3D", "RandomDepthicalFlip3D"]
# apply_batched on the card against the CPU (phase 8): float outputs within 1e-5 of the
# input's range; labels equal but where a coordinate lies within 1e-4 of a rounding tie,
# at most 1e-4 of the voxels
AUG_SHAPE, AUG_BATCHES = (32, 256, 256), (1, 4)
AUG_FLOAT_TOL, AUG_TIE, AUG_TIE_SHARE = 1e-5, 1e-4, 1e-4
# the DSB recipe (phase 9): experiments/dsb/train_dsb.py
DSB_MODEL = dict(in_channels=1, out_channels=2, initial_features=64, final_activation="Sigmoid")
DSB_DEPTH, DSB_BATCH, DSB_PATCH = 4, 8, (1, 256, 256)
DSB_IMAGES, DSB_FIT, DSB_RESUME, DSB_CLI_ITERATIONS = 16, 16, 4, 4
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
# device kernels of the profiler breakdowns: the port's norms, cuDNN's convs
NORM_KERNELS = re.compile(r"row_in_registers|row_in_cluster|row_through_l2")
CONV_KERNELS = re.compile(r"conv|cudnn|xmma|implicit_gemm|dgrad|wgrad|fprop|nchw|nhwc", re.I)


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


def path_of(inorm, shape, dtype, direction):
    """The kernel path (A, B or C) of a (channels, spatial) norm of batch 1."""
    c, sp = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return inorm.plan(c, int(np.prod(sp)), itemsize, direction, sms).path


def path_counts(inorm, shapes, dtype, direction):
    counts = {"A": 0, "B": 0, "C": 0}
    for shape in shapes:
        counts[path_of(inorm, shape, dtype, direction)] += 1
    return counts


def time_ms(fn, *args, iters=5, repeats=5):
    """Time of ``fn(*args)`` as called: the median over ``repeats`` runs of the mean of
    ``iters`` back-to-back calls between CUDA events, after one warm-up call. At small
    shapes the host's launch rate sets it, and the host is noisy."""
    fn(*args)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn(*args)
        stop.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(stop) / iters)
    return float(np.median(runs))


def profiled_kernels(fn, steps):
    """{kernel name: device ms per step} of ``steps`` calls of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        # kernels and copies; not the annotations that span them (e.g. "Optimizer.step")
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            out[e.key] = out.get(e.key, 0.0) + us / 1e3 / steps
    return out


def device_ms(fn, *args):
    """Device time of one call of ``fn(*args)``, host excluded: one replay of a CUDA graph
    that captured GRAPH_CALLS calls, over GRAPH_CALLS."""
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn(*args)
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / GRAPH_CALLS


def device_breakdown(label, fn, steps=3, top=8):
    """Log the top device kernels of ``fn`` by time, and the norms' and convs' shares."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / steps * 1e3
    kernels = profiled_kernels(fn, steps)
    total = sum(kernels.values())
    if total == 0:
        raise AssertionError(f"{label}: the profiler shows no device time")
    norms = sum(ms for k, ms in kernels.items() if NORM_KERNELS.search(k))
    convs = sum(ms for k, ms in kernels.items() if CONV_KERNELS.search(k) and not NORM_KERNELS.search(k))
    log(f"{label}: {total:.3f} ms of device kernels per call under the profiler, {wall:.3f} ms "
        f"wall per call without it (device idle {max(0.0, 1 - total / wall):.1%}); norms {norms:.3f} ms "
        f"({norms / total:.1%}), convs (cuDNN) {convs:.3f} ms ({convs / total:.1%}), other "
        f"{total - norms - convs:.3f} ms ({(total - norms - convs) / total:.1%})")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        log(f"    {ms:8.3f} ms {ms / total:6.1%}  {name[:110]}")
    return {"device_ms": total, "norm_ms": norms, "conv_ms": convs}


def card_generator(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def card_rand(gen, shape, dtype, offset=0):
    """Seeded normal(0.5, 2) values on the card; ``offset`` elements shift the base address."""
    n = int(np.prod(shape))
    buf = (torch.randn(n + offset, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    return buf[offset:].view(shape)


def output_tol(ref, dtype):
    if dtype == torch.float32:
        return torch.full_like(ref, F32_ATOL)
    if dtype == torch.bfloat16:
        return BF16_RTOL * ref.abs() + BF16_ATOL
    return F16_RTOL * ref.abs() + F16_RTOL_OF_MAX * ref.abs().max()


def check_kernel(kernel, plain, x):
    """Max abs error of kernel against plain version; raises past the tolerance."""
    y = kernel(x).float()
    ref = plain(x).float()
    torch.cuda.synchronize()
    err = (y - ref).abs()
    if not bool(torch.isfinite(y).all()) or bool((err > output_tol(ref, x.dtype)).any()):
        raise AssertionError(f"kernel disagrees at {tuple(x.shape)} {x.dtype}: "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def layout_cases(rand, dtype):
    """Inputs beside the main path's: ragged, odd-length, misaligned, strided, channels-last."""
    cases = [rand(s, dtype) for s in ((2, 3, 5, 7, 11), (1, 1, 3 * 16384 + 5), (1, 2, 40, 577, 577),
                                      (3, 4, 16))]
    for shape in ((1, 2, 1000), (1, 2, 65536)):  # base addresses off the 16-byte grid
        cases.append(rand(shape, dtype, offset=1))
        assert cases[-1].data_ptr() % 16 != 0
    cases.append(rand((1, 64, 8, 64, 64), dtype)[:, ::2])
    cases.append(rand((1, 32, 16, 64, 64), dtype).to(memory_format=torch.channels_last_3d))
    assert not cases[-1].is_contiguous() and not cases[-2].is_contiguous()
    return cases


def repeat_shapes(inorm, shapes, direction):
    """One main-path shape per kernel path (bf16), for the bitwise-repeat check."""
    found = {}
    for shape in shapes:
        found.setdefault(path_of(inorm, shape, torch.bfloat16, direction), shape)
    assert sorted(found) == ["A", "B", "C"], found
    return found


def dsb_paths(inorm, dsb_shapes, dtype, direction):
    """{path: (channels, spatial)} of the DSB step's norms (batch DSB_BATCH), first shape per path."""
    found = {}
    for c, sp in dsb_shapes:
        found.setdefault(path_of(inorm, (DSB_BATCH * c, sp), dtype, direction), (c, sp))
    return found


def phase_norm_kernel(inorm, shapes, train_shapes, dsb_shapes):
    """Check the forward kernel at every main-path shape (the DSB step's at batch
    DSB_BATCH) and time it at the serving path's; returns its entry of the kernels line."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dtype, offset=0):
        return card_rand(g, shape, dtype, offset)

    max_err = 0.0
    for dtype in DTYPES:
        hit = set()
        for c, sp in sorted(set(shapes) | set(train_shapes)):
            err = check_kernel(inorm.instance_norm, inorm.instance_norm_reference,
                               rand((1, c) + sp, dtype))
            max_err = max(max_err, err)
            hit.add(path_of(inorm, (c, sp), dtype, "forward"))
            log(f"  norm {dtype} C={c} {sp} path {path_of(inorm, (c, sp), dtype, 'forward')}: "
                f"max abs err {err:.3g}")
        assert hit == {"A", "B", "C"}, hit
        for x in layout_cases(rand, dtype):
            max_err = max(max_err, check_kernel(inorm.instance_norm, inorm.instance_norm_reference, x))
        log(f"  norm {dtype}: ragged, odd-length, misaligned, strided and channels-last inputs agree")
        for c, sp in sorted(set(dsb_shapes)):
            err = check_kernel(inorm.instance_norm, inorm.instance_norm_reference, rand((DSB_BATCH, c) + sp, dtype))
            max_err = max(max_err, err)
            log(f"  norm {dtype} DSB ({DSB_BATCH}, {c}) {sp} path "
                f"{path_of(inorm, (DSB_BATCH * c, sp), dtype, 'forward')}: max abs err {err:.3g}")
    repeats = [((1, c) + sp, path) for path, (c, sp) in repeat_shapes(inorm, shapes, "forward").items()]
    repeats += [((DSB_BATCH, c) + sp, f"{path} (DSB)")
                for path, (c, sp) in dsb_paths(inorm, dsb_shapes, torch.bfloat16, "forward").items()]
    for shape, path in repeats:
        x = rand(shape, torch.bfloat16)
        first, second = inorm.instance_norm_forward(x), inorm.instance_norm_forward(x)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"forward kernel path {path} is not bitwise repeatable")
    log(f"kernel agrees with instance_norm_reference: max abs err {max_err:.3g} "
        f"(f32 atol {F32_ATOL}; bf16 {BF16_RTOL:.3g}*|ref| + {BF16_ATOL}; f16 {F16_RTOL:.3g}*|ref| "
        f"+ {F16_RTOL_OF_MAX}*max|ref|); two calls bitwise equal on paths {[p for _, p in repeats]}")

    totals = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
              "library_device_ms": 0.0}
    for c, sp in sorted(set(shapes)):
        x = rand((1, c) + sp, torch.bfloat16)
        count = shapes.count((c, sp))
        t = time_norm(inorm, x, f"C={c} {sp} x{count}")
        for key in totals:
            totals[key] += count * t[key]
        del x
    for c, sp in sorted(repeat_shapes(inorm, shapes, "forward").values()):
        time_norm(inorm, rand((1, c) + sp, torch.float16), f"C={c} {sp}")
    torch.cuda.empty_cache()
    log(f"per serving forward ({len(shapes)} norms, bf16): kernel {totals['ms']:.3f} ms as called, "
        f"{totals['device_ms']:.3f} ms device; plain {totals['plain_ms']:.3f} ms, F.instance_norm "
        f"{totals['library_ms']:.3f} ms as called, {totals['library_device_ms']:.3f} ms device; "
        f"bound {totals['bound_ms']:.3f} ms")
    return {
        "name": "instance_norm",
        "route": "cuda",
        "source": "torch_em_tpu_torch/ops/csrc/instance_norm.cu",
        "replaces": "torch_em_tpu/ops/pallas/norm.py:83",
        "launches": None,
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "device_ms": totals["device_ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes",
        "library_ms": totals["library_ms"],
        "paths": {"serving": path_counts(inorm, shapes, torch.bfloat16, "forward"),
                  "training": path_counts(inorm, train_shapes, torch.bfloat16, "forward"),
                  "dsb_training": path_counts(inorm, [(DSB_BATCH * c, sp) for c, sp in dsb_shapes],
                                              torch.bfloat16, "forward")},
    }


def time_norm(inorm, x, label):
    """Forward times at one shape: kernel as called and device-only, plain version,
    F.instance_norm as called and device-only, and the byte bound."""
    t = {"ms": time_ms(inorm.instance_norm, x), "device_ms": device_ms(inorm.instance_norm, x),
         "plain_ms": time_ms(inorm.instance_norm_reference, x),
         "library_ms": time_ms(torch.nn.functional.instance_norm, x),
         "library_device_ms": device_ms(torch.nn.functional.instance_norm, x),
         "bound_ms": 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3}
    y = torch.empty_like(x)
    copy_ms = device_ms(y.copy_, x)  # the same bytes moved by a plain copy: a practical bound
    path = path_of(inorm, (x.shape[1], tuple(x.shape[2:])), x.dtype, "forward")
    log(f"  time {x.dtype} {label} path {path}: kernel {t['ms']:.4f} ms as called, "
        f"{t['device_ms']:.4f} ms device; plain {t['plain_ms']:.4f} ms; F.instance_norm "
        f"{t['library_ms']:.4f} ms as called, {t['library_device_ms']:.4f} ms device; "
        f"bound {t['bound_ms']:.4f} ms, copy_ {copy_ms:.4f} ms device")
    return t


class TimedModel(torch.nn.Module):
    """The model, with a pair of CUDA events around each forward."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.out_channels = model.out_channels
        self.events = []

    def forward(self, x):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.model(x)
        stop.record()
        self.events.append((start, stop))
        return out

    def device_ms(self):
        torch.cuda.synchronize()
        return sum(start.elapsed_time(stop) for start, stop in self.events)


def serve(port, inorm, model, volume, path, runs=2):
    """``predict_with_halo`` on ``volume`` through the host path (``path`` "host": the numpy
    volume) or the device-resident one ("device": a copy on the card, made before the
    call); the last of ``runs`` calls is timed, the first pays for cuDNN's first calls.

    Returns the output as a float32 numpy array and the timed call's numbers: wall time,
    Mvox/s, ms per block, the forwards' device time (CUDA events around each), the
    device's idle share (the wall time outside the forwards) and the norm kernel's
    launches, counted from 0 just before the call."""
    timed = TimedModel(model)
    x = volume if path == "host" else torch.from_numpy(volume).cuda()
    n_blocks = port.Blocking([0] * volume.ndim, volume.shape, BLOCK_SHAPE).n_blocks
    for _ in range(runs):
        timed.events.clear()
        torch.cuda.synchronize()
        inorm.instance_norm.launches = 0
        t = time.perf_counter()
        out = port.predict_with_halo(x, timed, block_shape=BLOCK_SHAPE, halo=HALO, output_dtype="float16")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = inorm.instance_norm.launches
    forward_ms = timed.device_ms()
    if path == "device":
        if not (isinstance(out, torch.Tensor) and out.device == x.device and out.dtype == torch.float16):
            raise AssertionError(f"the device-resident path returned {type(out)}")
        out = out.float().cpu().numpy()
    del x
    stats = {"path": path, "volume": list(volume.shape), "blocks": n_blocks, "seconds": seconds,
             "mvox_per_s": volume.size / seconds / 1e6, "ms_per_block": seconds / n_blocks * 1e3,
             "forward_device_ms": forward_ms, "device_idle": max(0.0, 1 - forward_ms / (seconds * 1e3)),
             "launches": launches}
    log(f"{path} path {volume.shape}: {stats['mvox_per_s']:.2f} Mvox/s, {stats['ms_per_block']:.1f} ms "
        f"per block ({seconds:.3f} s for {n_blocks} blocks); forwards {forward_ms:.1f} ms device "
        f"({forward_ms / n_blocks:.2f} ms per block), device idle {stats['device_idle']:.1%} of the call; "
        f"{launches} norm launches")
    if out.shape != (1,) + volume.shape:
        raise AssertionError(f"output shape {out.shape}")
    if not np.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError("output is not finite or leaves [0, 1]")
    if launches != NORMS_PER_FORWARD * n_blocks:
        raise AssertionError(f"{launches} kernel launches, expected {NORMS_PER_FORWARD} x {n_blocks} blocks")
    return out, stats


def serial_predict(port, model, volume):
    """A plain serial block loop: each block loaded and standardized on the host, then
    predicted alone and cast to float16 on the card."""
    blocking = port.Blocking([0] * volume.ndim, volume.shape, BLOCK_SHAPE)
    out = np.zeros((1,) + volume.shape, dtype=np.float32)
    inner = tuple(slice(h, h + b) for h, b in zip(HALO, BLOCK_SHAPE))
    with torch.inference_mode():
        for block_id in range(blocking.n_blocks):
            begin, end = blocking.get_block(block_id)
            inp, _ = port.utils.prediction._load_block(volume, begin, BLOCK_SHAPE, HALO)
            x = torch.from_numpy(port.standardize(inp)[None, None]).cuda()
            pred = model(x)[(0, slice(None)) + inner].half().float().cpu().numpy()
            actual = tuple(slice(0, e - b) for b, e in zip(begin, end))
            out[(slice(None),) + tuple(slice(b, e) for b, e in zip(begin, end))] = pred[(slice(None),) + actual]
    return out


def check_close(label, got, expected):
    diff = np.abs(got - expected)
    log(f"{label}: max abs diff {float(diff.max()):.3g}, mean {float(diff.mean()):.3g} "
        f"(limits {MODEL_BF16_MAX}, {MODEL_BF16_MEAN})")
    if float(diff.max()) > MODEL_BF16_MAX or float(diff.mean()) > MODEL_BF16_MEAN:
        raise AssertionError(f"{label} disagree")


def phase_main_path(port, inorm, unet_module):
    """Full-width tiled inference through both paths on both volumes; returns the norm
    kernel's launches summed over the timed calls, and their numbers."""
    model = port.AnisotropicUNet(**TRACKED, dtype=torch.bfloat16, device="cuda", seed=0)
    launches, results = 0, []
    for shape in SERVING_VOLUMES:
        volume = np.random.default_rng(0).random(shape, dtype=np.float32)
        host, host_stats = serve(port, inorm, model, volume, "host")
        device, device_stats = serve(port, inorm, model, volume, "device")
        check_close(f"{shape}: device-resident path vs host path", device, host)
        if shape == VOLUME_SHAPE:
            check_close(f"{shape}: host path vs a serial loop with host standardize", host,
                        serial_predict(port, model, volume))
        del host, device
        launches += host_stats["launches"] + device_stats["launches"]
        results += [host_stats, device_stats]
    log(f"serving: {json.dumps(results)}")
    volume = np.random.default_rng(0).random(VOLUME_SHAPE, dtype=np.float32)

    t = time.perf_counter()
    inp, _ = port.utils.prediction._load_block(volume, (0, 0, 0), BLOCK_SHAPE, HALO)
    inp = port.standardize(inp)
    host_ms = (time.perf_counter() - t) * 1e3
    x = torch.from_numpy(inp[None, None]).cuda()
    with torch.inference_mode():
        fwd_ms = time_ms(model, x, iters=3, repeats=1)
        torch.cuda.reset_peak_memory_stats()
        y_kernel = model(x)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with unittest.mock.patch.object(unet_module, "instance_norm", inorm.instance_norm_reference):
            y_plain = model(x)
    log(f"one halo block {tuple(x.shape)}: host load + standardize {host_ms:.1f} ms, "
        f"model forward {fwd_ms:.2f} ms on the device, peak memory {peak:.2f} GiB")
    with torch.inference_mode():
        device_breakdown("serving forward of one halo block (bf16)", lambda: model(x))
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
    return launches


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
        step = BWD_BF16_RTOL if x.dtype == torch.bfloat16 else BWD_F16_RTOL
        tol = step * ref.abs() + BWD_BF16_RTOL_OF_MAX * scale
    err = (dx - ref).abs()
    if not bool(torch.isfinite(dx).all()) or bool((err > tol).any()):
        raise AssertionError(f"backward kernel disagrees at {tuple(x.shape)} {x.dtype}: "
                             f"max abs err {float(err.max())} (max |dx| {scale})")
    return float(err.max())


def phase_backward_kernel(inorm, shapes, serving_shapes, dsb_shapes):
    """Check the backward kernel at every main-path shape (the DSB step's at batch
    DSB_BATCH) and time both kernels at the two training paths' shapes.

    Returns the backward kernel's entry of the kernels line, with times summed
    over the norms whose backward one training step runs: all but the first,
    whose input is the raw patch, which needs no gradient; and the forward
    kernel's times per step of each training path."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(shape, dtype, offset=0):
        return card_rand(gen, shape, dtype, offset)

    max_err = 0.0
    for dtype in DTYPES:
        hit = set()
        for c, sp in sorted(set(shapes) | set(serving_shapes)):
            shape = (1, c) + sp
            err = check_backward(inorm, rand(shape, dtype), rand(shape, dtype))
            max_err = max(max_err, err)
            path = path_of(inorm, (c, sp), dtype, "backward")
            hit.add(path)
            log(f"  backward {dtype} C={c} {sp} path {path}: max abs err {err:.3g}")
        assert hit == {"A", "B", "C"}, hit
        for x in layout_cases(rand, dtype):
            max_err = max(max_err, check_backward(inorm, x, rand(x.shape, dtype)))
        # autograd may hand over a non-contiguous gradient; the wrapper copies it
        g = rand((1, 64, 8, 64, 64), dtype)[:, ::2]
        assert not g.is_contiguous()
        max_err = max(max_err, check_backward(inorm, rand(g.shape, dtype), g))
        log(f"  backward {dtype}: ragged, odd-length, misaligned, strided, channels-last and "
            f"non-contiguous-gradient cases agree")
        for c, sp in sorted(set(dsb_shapes)):
            shape = (DSB_BATCH, c) + sp
            err = check_backward(inorm, rand(shape, dtype), rand(shape, dtype))
            max_err = max(max_err, err)
            log(f"  backward {dtype} DSB {shape[:2]} {sp} path "
                f"{path_of(inorm, (DSB_BATCH * c, sp), dtype, 'backward')}: max abs err {err:.3g}")
    repeats = [((1, c) + sp, path) for path, (c, sp) in repeat_shapes(inorm, shapes, "backward").items()]
    repeats += [((DSB_BATCH, c) + sp, f"{path} (DSB)")
                for path, (c, sp) in dsb_paths(inorm, dsb_shapes, torch.bfloat16, "backward").items()]
    for shape, path in repeats:
        x, g = rand(shape, torch.bfloat16), rand(shape, torch.bfloat16)
        _, mean, rstd = inorm.instance_norm_forward_reference(x)
        if not torch.equal(inorm.instance_norm_backward(x, g, mean, rstd),
                           inorm.instance_norm_backward(x, g, mean, rstd)):
            raise AssertionError(f"backward kernel path {path} is not bitwise repeatable")
    log(f"backward kernel agrees with instance_norm_backward_reference: max abs err {max_err:.3g} "
        f"(f32 {BWD_F32_RTOL_OF_MAX}*max|dx|; bf16 {BWD_BF16_RTOL:.3g}*|ref| + "
        f"{BWD_BF16_RTOL_OF_MAX}*max|dx|; f16 {BWD_F16_RTOL:.3g}*|ref| + "
        f"{BWD_BF16_RTOL_OF_MAX}*max|dx|); two calls bitwise equal on paths {[p for _, p in repeats]}")

    fwd, bwd = time_step_norms(inorm, rand, shapes, 1, "tracked")
    dsb_fwd, dsb_bwd = time_step_norms(inorm, rand, dsb_shapes, DSB_BATCH, "DSB")
    for c, sp in sorted(repeat_shapes(inorm, shapes, "backward").values()):
        time_step_norm(inorm, rand((1, c) + sp, torch.float16), rand((1, c) + sp, torch.float16),
                       f"C={c} {sp}")
    torch.cuda.empty_cache()
    step_shapes = shapes[1:]
    return {
        "name": "instance_norm_backward",
        "route": "cuda",
        "source": "torch_em_tpu_torch/ops/csrc/instance_norm_bwd.cu",
        "replaces": "torch_em_tpu/ops/pallas/norm.py:94",
        "launches": None,
        "max_abs_err": max_err,
        "ms": bwd["ms"],
        "device_ms": bwd["device_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": "bytes",
        "library_ms": bwd["library_ms"],
        "paths": {"training": path_counts(inorm, step_shapes, torch.bfloat16, "backward"),
                  "dsb_training": path_counts(inorm, [(DSB_BATCH * c, sp) for c, sp in dsb_shapes[1:]],
                                              torch.bfloat16, "backward")},
        "dsb_training": dsb_bwd,
    }, fwd, dsb_fwd


def time_step_norms(inorm, rand, shapes, batch, label):
    """Both kernels' times per training step (bf16) summed over a step's norms: the forward
    at every norm, the backward at all but the first; returns (forward, backward)."""
    step_shapes = shapes[1:]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")
    fwd, bwd = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
    for c, sp in sorted(set(shapes)):
        f, b = time_step_norm(inorm, rand((batch, c) + sp, torch.bfloat16),
                              rand((batch, c) + sp, torch.bfloat16), f"{label} ({batch}, {c}) {sp}")
        n_fwd, n_bwd = shapes.count((c, sp)), step_shapes.count((c, sp))
        for key in keys:
            fwd[key] += n_fwd * f[key]
            bwd[key] += n_bwd * b[key]
    for name, t, n in (("forward", fwd, len(shapes)), ("backward", bwd, len(step_shapes))):
        log(f"per {label} training step, {name} ({n} norms, bf16): kernel {t['ms']:.3f} ms as called, "
            f"{t['device_ms']:.3f} ms device; plain {t['plain_ms']:.3f} ms, F.instance_norm "
            f"{t['library_ms']:.3f} ms; bound {t['bound_ms']:.3f} ms")
    return fwd, bwd


def time_step_norm(inorm, x, g, label):
    """Training-step times at one shape, forward (with its statistics) and backward:
    kernel as called and device-only, plain version, library call, byte bound."""
    F = torch.nn.functional
    size = x.numel() * x.element_size()
    _, mean, rstd = inorm.instance_norm_forward_reference(x)
    xr = x.detach().requires_grad_()
    yr = F.instance_norm(xr)
    f = {"ms": time_ms(inorm.instance_norm_forward, x),
         "device_ms": device_ms(inorm.instance_norm_forward, x),
         "plain_ms": time_ms(inorm.instance_norm_forward_reference, x),
         "library_ms": time_ms(F.instance_norm, x), "bound_ms": 2 * size / HBM_BYTES_PER_S * 1e3}
    b = {"ms": time_ms(inorm.instance_norm_backward, x, g, mean, rstd),
         "device_ms": device_ms(inorm.instance_norm_backward, x, g, mean, rstd),
         "plain_ms": time_ms(inorm.instance_norm_backward_reference, x, g, mean, rstd),
         "library_ms": time_ms(lambda: torch.autograd.grad(yr, xr, g, retain_graph=True)),
         "bound_ms": 3 * size / HBM_BYTES_PER_S * 1e3}
    paths = [path_of(inorm, (x.shape[1], tuple(x.shape[2:])), x.dtype, d) for d in ("forward", "backward")]
    log(f"  time {x.dtype} {label} fwd path {paths[0]}: kernel {f['ms']:.4f} ms as called, "
        f"{f['device_ms']:.4f} ms device; plain {f['plain_ms']:.4f} ms; F.instance_norm "
        f"{f['library_ms']:.4f} ms; bound {f['bound_ms']:.4f} ms | bwd path {paths[1]}: kernel "
        f"{b['ms']:.4f} ms as called, {b['device_ms']:.4f} ms device; plain {b['plain_ms']:.4f} "
        f"ms; F.instance_norm backward {b['library_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms")
    return f, b


def training_volume(port, seed=0):
    """A seeded raw volume and instance labels derived from it: raw is smoothed noise,
    the labels the connected components of a threshold of raw smoothed once more."""
    from scipy import ndimage

    noise = np.random.default_rng(seed).normal(size=TRAIN_VOLUME).astype(np.float32)
    raw = ndimage.gaussian_filter(noise, 1.0)
    raw = (raw - raw.mean()) / raw.std()
    labels = port.transforms.connected_components(ndimage.gaussian_filter(raw, 2.0) > 0)
    return raw, labels


class LossLog:
    """Trainer logger that keeps the training losses and validation metrics."""

    def __init__(self, trainer, save_root, **kwargs):
        self.losses, self.metrics = [], []

    def log_train(self, step, loss, lr, x, y, prediction, log_gradients=False):
        self.losses.append(loss)

    def log_validation(self, step, metric, loss, x, y, prediction):
        self.metrics.append(metric)


def phase_training(port, inorm, device_ops):
    """The training path; returns the forward and backward kernel launches of its run."""
    raw, labels = training_volume(port)
    log(f"training volume {raw.shape}: {int(labels.max())} instances")
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "raw.npy"), raw)
        np.save(os.path.join(tmp, "labels.npy"), labels)
        del raw, labels

        def loader(n_samples, shuffle, label_transform=None):
            ds = port.SegmentationDataset(
                os.path.join(tmp, "raw.npy"), None, os.path.join(tmp, "labels.npy"), None,
                patch_shape=TRAIN_PATCH, n_samples=n_samples, raw_transform=port.standardize,
                label_transform=label_transform)
            return port.DataLoader(ds, batch_size=1, shuffle=shuffle, num_workers=LOADER_THREADS)

        np.random.seed(0)
        model = port.AnisotropicUNet(**TRACKED, device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "smoke", model, loader(TRAIN_SAMPLES, True), loader(VAL_SAMPLES, False),
            learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True, logger=LossLog,
            save_root=tmp, device_label_transform=device_ops.DeviceAffinityTransform(offsets=OFFSETS))
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
        restored = resumed.device_label_transform
        if not (isinstance(restored, device_ops.DeviceAffinityTransform)
                and restored.init_kwargs == trainer.device_label_transform.init_kwargs):
            raise AssertionError(f"from_checkpoint restored the label transform {restored!r}")
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

        check_label_transforms(port, device_ops, resumed.train_loader.dataset)
        time_loaders(port, resumed, loader)

        # one training step on a device-resident batch
        x, y = (v.cuda() for v in next(iter(resumed.train_loader)))
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(resumed._train_step, x, y, iters=10, repeats=1)
        t = time.perf_counter()
        for _ in range(10):
            resumed._train_step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) / 10 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"training step {tuple(x.shape)} bf16: {step_ms:.2f} ms device (CUDA events), "
            f"{wall_ms:.2f} ms wall, {1e3 / wall_ms:.2f} patches/s, peak memory {peak:.2f} GiB; "
            f"{nvidia_smi()}")
        device_breakdown("training step (bf16 forward, backward, AdamW)",
                         lambda: resumed._train_step(x, y))
        del trainer, resumed, model
    torch.cuda.empty_cache()
    check_training_gradients(port, inorm, x, device_ops.DeviceAffinityTransform(offsets=OFFSETS)(y))
    return launches


def check_label_transforms(port, device_ops, dataset, n=4):
    """The device affinity and boundary transforms on the card against the host ones,
    on ``n`` label patches of the training set: equal."""
    labels = torch.stack([torch.from_numpy(dataset[i][1]) for i in range(n)])  # (n, 1, *patch) float32
    cases = ((device_ops.DeviceAffinityTransform(offsets=OFFSETS), port.transforms.AffinityTransform(OFFSETS)),
             (device_ops.DeviceBoundaryTransform(), port.transforms.BoundaryTransform()))
    for on_card, on_host in cases:
        got = on_card(labels.cuda()).cpu().numpy()
        expected = np.stack([on_host(sample[0]).astype(np.float32) for sample in labels.numpy()])
        if got.shape != expected.shape or not np.array_equal(got, expected):
            raise AssertionError(f"{type(on_card).__name__} on the card differs from "
                                 f"{type(on_host).__name__} on the host")
        log(f"{type(on_card).__name__} on the card equals {type(on_host).__name__} on the host on {n} "
            f"label patches {tuple(labels.shape[2:])} ({float(got.mean()):.4f} of the target set)")


def time_loaders(port, trainer, loader):
    """Patches/s of the loader (LOADER_THREADS threads) feeding training steps, as the
    tracked benchmark times it: the host ``AffinityTransform`` in the loader, then raw
    labels with ``DeviceAffinityTransform`` inside the step."""
    device_transform = trainer.device_label_transform
    for mode, label_transform, step_transform in (
            ("host AffinityTransform", port.transforms.AffinityTransform(OFFSETS), None),
            ("DeviceAffinityTransform in the step", None, device_transform)):
        trainer.device_label_transform = step_transform
        it = iter(loader(2 + LOADER_STEPS, True, label_transform))
        for k in range(2 + LOADER_STEPS):
            if k == 2:
                torch.cuda.synchronize()
                t = time.perf_counter()
            x, y = next(it)
            trainer._train_step(x.cuda(non_blocking=True), y.cuda(non_blocking=True))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        log(f"loader with {mode}, {LOADER_THREADS} threads, with the step: "
            f"{LOADER_STEPS / seconds:.2f} patches/s ({seconds / LOADER_STEPS * 1e3:.1f} ms per patch)")
    trainer.device_label_transform = device_transform


def check_training_gradients(port, inorm, x, y):
    """One float32 training step (TF32 off): the kernels against the plain versions,
    each against the same step in float64."""
    model = port.AnisotropicUNet(**TRACKED, dtype=torch.float32, device="cuda", seed=1)

    def grads(net, xb, yb):
        net.zero_grad(set_to_none=True)
        port.DiceLoss()(net(xb), yb).backward()
        return {n: p.grad.clone() for n, p in net.named_parameters()}

    def plain_forward(x, eps, stats=True):  # the entry of inputs that need no gradient
        return inorm.instance_norm_forward_reference(x, eps)

    plain_norm = [unittest.mock.patch.object(inorm, name, fn) for name, fn in (
        ("instance_norm_forward", inorm.instance_norm_forward_reference),
        ("instance_norm_backward", inorm.instance_norm_backward_reference),
        ("_instance_norm_cuda", plain_forward))]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kernel = grads(model, x, y)
        with plain_norm[0], plain_norm[1], plain_norm[2]:
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


def fit_and_resume(port, inorm, trainer, fit_iterations, resume_iterations, val_patches, label):
    """Fit, rebuild with ``from_checkpoint``, fit on; check iteration counts, a finite and
    falling loss, the checkpoints and both kernels' launches (counted from 0 here).
    Returns the resumed trainer, the launches and the first fit's wall seconds."""
    folder = trainer.checkpoint_folder
    torch.cuda.synchronize()
    inorm.instance_norm.launches = inorm.instance_norm_backward.launches = 0
    t = time.perf_counter()
    trainer.fit(iterations=fit_iterations)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    resumed = port.DefaultTrainer.from_checkpoint(folder, "latest")
    if resumed.iteration != fit_iterations:
        raise AssertionError(f"{label}: from_checkpoint restored iteration {resumed.iteration}")
    resumed.fit(iterations=resume_iterations)
    torch.cuda.synchronize()
    launches = (inorm.instance_norm.launches, inorm.instance_norm_backward.launches)
    steps = fit_iterations + resume_iterations
    if trainer.iteration != fit_iterations or resumed.iteration != steps:
        raise AssertionError(f"{label}: iterations {trainer.iteration}, resumed {resumed.iteration}")
    validations = len(trainer.logger.metrics) + len(resumed.logger.metrics)
    expected = (NORMS_PER_FORWARD * (steps + val_patches * validations), (NORMS_PER_FORWARD - 1) * steps)
    log(f"{label}: launches forward {launches[0]}, backward {launches[1]} for {steps} steps and "
        f"{validations} validations of {val_patches} patch(es) (expected {expected})")
    if launches != expected:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}")
    losses = trainer.logger.losses + resumed.logger.losses
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[fit_iterations - 4:fit_iterations]))
    log(f"{label}: loss over {len(losses)} steps: first four {first:.4f}, last four of the first fit "
        f"{last:.4f}, last {losses[-1]:.4f}; fit {fit_iterations} iterations in {fit_s:.2f} s wall")
    if len(losses) != steps or not np.all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"{label}: the training loss is not finite or does not fall")
    if not {"best.ckpt", "latest.ckpt"} <= set(os.listdir(folder)):
        raise AssertionError(f"{label}: checkpoints {os.listdir(folder)}")
    return resumed, launches


def loader_rate(trainer, loader, steps=LOADER_STEPS, warmup=2):
    """Patches/s of ``loader`` feeding the trainer's steps, after ``warmup`` steps."""
    it = iter(loader)
    for k in range(warmup + steps):
        if k == warmup:
            torch.cuda.synchronize()
            t = time.perf_counter()
        x, y = next(it)
        trainer._train_step(x.cuda(non_blocking=True), y.cuda(non_blocking=True))
    torch.cuda.synchronize()
    return steps * loader.batch_size / (time.perf_counter() - t)


def bare_step(trainer, loader, label):
    """Device ms (CUDA events) and wall ms of the trainer's step on a device-resident batch."""
    x, y = (v.cuda() for v in next(iter(loader)))
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(trainer._train_step, x, y, iters=10, repeats=1)
    t = time.perf_counter()
    for _ in range(10):
        trainer._train_step(x, y)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) / 10 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{label} step {tuple(x.shape)} bf16: {step_ms:.2f} ms device (CUDA events), {wall_ms:.2f} ms wall, "
        f"{x.shape[0] * 1e3 / wall_ms:.2f} patches/s, peak memory {peak:.2f} GiB; {nvidia_smi()}")
    return x, y


def phase_factory_3d(port, inorm, device_ops):
    """The 3-D recipe through ``default_segmentation_loader``: a ConcatDataset over two
    ``.npy`` volumes with the default (anisotropic flip) augmentations and ``standardize``;
    returns the kernels' launches of its training run."""
    with tempfile.TemporaryDirectory() as tmp:
        raws, labels = [], []
        for seed in range(2):
            raw, lab = training_volume(port, seed)
            raws.append(os.path.join(tmp, f"raw{seed}.npy"))
            labels.append(os.path.join(tmp, f"labels{seed}.npy"))
            np.save(raws[-1], raw)
            np.save(labels[-1], lab)
        del raw, lab

        def loader(n_samples=None, shuffle=True, transform=None):
            return port.default_segmentation_loader(
                raws, None, labels, None, batch_size=1, patch_shape=TRAIN_PATCH, num_workers=LOADER_THREADS,
                shuffle=shuffle, n_samples=n_samples, transform=transform)

        train = loader()
        ds = train.dataset
        pipeline = ds.datasets[0].transform
        if not (isinstance(ds, port.data.ConcatDataset) and pipeline.init_kwargs == {
                "ndim": "anisotropic", "transforms": FLIPS_3D}):
            raise AssertionError(f"factory built {type(ds).__name__} with {pipeline.init_kwargs}")
        log(f"factory loader: {type(ds).__name__} of {len(ds.datasets)} volumes, {len(ds)} patches, "
            f"transform {pipeline.init_kwargs}, raw transform {type(ds.datasets[0].raw_transform).__name__}")
        np.random.seed(1)
        model = port.AnisotropicUNet(**TRACKED, device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "factory-3d", model, train, loader(n_samples=VAL_SAMPLES, shuffle=False),
            learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True, logger=LossLog,
            save_root=tmp, device_label_transform=device_ops.DeviceAffinityTransform(offsets=OFFSETS))
        resumed, launches = fit_and_resume(port, inorm, trainer, RECIPE_FIT, RECIPE_RESUME, VAL_SAMPLES,
                                           "3-D recipe")
        restored = resumed.train_loader.dataset
        if not (isinstance(restored, port.data.ConcatDataset)
                and restored.datasets[0].transform.init_kwargs == pipeline.init_kwargs):
            raise AssertionError(f"from_checkpoint rebuilt {type(restored).__name__}")

        n = 2 + LOADER_STEPS  # patches per timed run, half from each volume
        no_transform = port.DataLoader(port.data.ConcatDataset(*[
            port.SegmentationDataset(r, None, lab, None, patch_shape=TRAIN_PATCH, n_samples=n // 2,
                                     raw_transform=port.standardize)
            for r, lab in zip(raws, labels)]), batch_size=1, shuffle=True, num_workers=LOADER_THREADS)
        elastic = port.transforms.get_augmentations(3, FLIPS_3D + ["RandomElasticDeformation3D"])
        for mode, modes_loader in (("no transform", no_transform), ("default flips", loader(n)),
                                   ("flips + RandomElasticDeformation3D", loader(n, transform=elastic))):
            rate = loader_rate(resumed, modes_loader)
            log(f"3-D loader, {mode}, {LOADER_THREADS} threads, DeviceAffinityTransform in the step: "
                f"{rate:.2f} patches/s ({1e3 / rate:.1f} ms per patch)")
        raw, lab = ds.datasets[0]._get_sample(0)
        elastic(raw, lab)
        t = time.perf_counter()
        for _ in range(3):
            out = elastic(raw, lab)
        log(f"host path of flips + RandomElasticDeformation3D on one {TRAIN_PATCH} raw and label patch, "
            f"alone: {(time.perf_counter() - t) / 3 * 1e3:.1f} ms per sample, {torch.get_num_threads()} "
            f"intra-op threads; outputs {[tuple(a.shape) for a in out]} {out[0].dtype}")
        del trainer, resumed, model
    torch.cuda.empty_cache()
    return launches


def tie_mask(aug, spatial, params):
    """Voxels (B, 1, *spatial) where a sampling coordinate of ``aug`` lies within AUG_TIE of a
    rounding tie of order 0 (None for the flips, which do not resample)."""
    if not aug.interpolating:
        return None
    coords = aug.coords(spatial, params)  # an elastic field covers the last two axes only
    near = torch.zeros_like(coords[0], dtype=torch.bool)
    for c in coords:
        near |= ((c - torch.floor(c)) - 0.5).abs() < AUG_TIE
    return near.reshape(near.shape[:1] + (1,) * (1 + len(spatial) - len(coords)) + near.shape[1:])


def phase_apply_batched(port):
    """Every registry entry through ``apply_batched``'s apply on the card and on the CPU with the
    same parameters; times each entry per batch on the card and per sample on the host."""
    from torch_em_tpu_torch.transforms import augmentation as A

    rows = []
    gen = torch.Generator().manual_seed(0)
    for name, kwargs in A.AUGMENTATIONS.items():
        aug = A.create_augmentation(name)
        planar = name in ("RandomRotation", "RandomAffine", "RandomElasticDeformation")
        for batch in AUG_BATCHES:
            # a 2-D entry cannot warp a 3-D patch (nor can the JAX package's): its 32 planes are channels
            shape = (batch,) + ((AUG_SHAPE[0],) + AUG_SHAPE[1:] if planar else (1,) + AUG_SHAPE)
            spatial = shape[2:]
            raw = torch.rand(shape, generator=gen)
            labels = torch.randint(0, 1000, shape, generator=gen)
            params = A._stack([aug.sample_params(gen, spatial) for _ in range(batch)])
            params["apply"] = torch.ones(batch, dtype=torch.bool)  # every element transformed
            on_card = {k: v.cuda() for k, v in params.items()}
            raw_cpu, lab_cpu = aug.apply_batch(raw, params, 1), aug.apply_batch(labels, params, 0)
            raw_card = aug.apply_batch(raw.cuda(), on_card, 1).cpu()
            lab_card = aug.apply_batch(labels.cuda(), on_card, 0).cpu()
            float_err = float((raw_card - raw_cpu).abs().max()) / float(raw.max() - raw.min())
            differ = lab_card != lab_cpu
            near = tie_mask(aug, spatial, params)
            unexplained = int((differ & ~near.expand_as(differ)).sum()) if near is not None else int(differ.sum())
            n_ties = int(near.expand_as(differ).sum()) if near is not None else 0
            if float_err > AUG_FLOAT_TOL or unexplained or int(differ.sum()) > AUG_TIE_SHARE * differ.numel():
                raise AssertionError(f"{name} {shape}: card vs CPU float err {float_err:.3g} of the range, "
                                     f"{int(differ.sum())} labels differ ({unexplained} away from a tie)")
            pipeline = A.AugmentationPipeline(aug)
            card_gen = card_generator(1)
            raw_c, lab_c = raw.cuda(), labels.cuda()
            card_ms = time_ms(lambda: pipeline.apply_batched(card_gen, raw_c, lab_c), iters=3, repeats=3)
            host_ms = None
            if batch == 1:
                raw_np, lab_np = raw[0].numpy(), labels[0].numpy().astype(np.uint32)
                pipeline(raw_np, lab_np)
                t = time.perf_counter()
                for _ in range(3):
                    pipeline(raw_np, lab_np)
                host_ms = (time.perf_counter() - t) / 3 * 1e3
            rows.append({"entry": name, "shape": list(shape), "float_err_of_range": float_err,
                         "labels_differ": int(differ.sum()), "near_ties": n_ties,
                         "card_ms_per_batch": card_ms, "host_ms_per_sample": host_ms})
            log(f"  {name} {shape}: card vs CPU float err {float_err:.3g} of the range, "
                f"{int(differ.sum())} labels differ ({n_ties} voxels near a tie); apply_batched "
                f"{card_ms:.3f} ms per batch on the card"
                + (f", host path {host_ms:.1f} ms per sample" if host_ms is not None else ""))
            del raw_c, lab_c
    log(f"apply_batched: {json.dumps(rows)}")
    torch.cuda.empty_cache()


def dsb_images(folder, seed=0):
    """DSB_IMAGES seeded 2-D images and instance labels as ``.npy`` under ``folder``/images and
    ``folder``/masks: raw is smoothed noise plus bright disks, the labels the disks."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    paths = {"images": [], "masks": []}
    for sub in paths:
        os.makedirs(os.path.join(folder, sub))
    for i in range(DSB_IMAGES):
        h, w = int(rng.integers(200, 361)), int(rng.integers(240, 361))
        labels = np.zeros((h, w), dtype=np.uint16)
        yy, xx = np.mgrid[:h, :w]
        for k in range(1, int(rng.integers(8, 20)) + 1):
            cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(6, 20)
            labels[(yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2] = k
        raw = ndimage.gaussian_filter(rng.normal(size=(h, w)), 2.0) + 2.0 * (labels > 0)
        for sub, arr in (("images", raw.astype(np.float32)), ("masks", labels)):
            paths[sub].append(os.path.join(folder, sub, f"{i:02d}.npy"))
            np.save(paths[sub][-1], arr)
    return paths["images"], paths["masks"]


def phase_dsb(port, inorm):
    """The DSB recipe: UNet2d at DSB width through ``default_segmentation_loader`` over image
    files, bf16, then the training and tiled-prediction CLI in subprocesses; returns the
    kernels' launches of its training run."""
    from torch_em_tpu_torch.transforms import AugmentationPipeline, BoundaryTransform

    with tempfile.TemporaryDirectory() as tmp:
        raw_files, label_files = dsb_images(tmp)
        shapes = sorted({np.load(f, mmap_mode="r").shape for f in raw_files})
        log(f"DSB data: {len(raw_files)} images from {shapes[0]} to {shapes[-1]}")

        def loader(n_samples, shuffle, workers=LOADER_THREADS):
            return port.default_segmentation_loader(
                raw_files, None, label_files, None, batch_size=DSB_BATCH, patch_shape=DSB_PATCH, ndim=2,
                is_seg_dataset=False, label_transform=BoundaryTransform(add_binary_target=True),
                num_workers=workers, shuffle=shuffle, n_samples=n_samples)

        by_list = loader(DSB_BATCH * DSB_FIT, True).dataset
        by_glob = port.default_segmentation_dataset(
            os.path.join(tmp, "images"), "*.npy", os.path.join(tmp, "masks"), "*.npy", patch_shape=DSB_PATCH,
            ndim=2, label_transform=BoundaryTransform(add_binary_target=True), n_samples=DSB_BATCH * DSB_FIT)
        for ds in (by_list, by_glob):
            if not (type(ds).__name__ == "ImageCollectionDataset"
                    and ds.transform.init_kwargs == {"ndim": 2, "transforms": ["RandomHorizontalFlip",
                                                                              "RandomVerticalFlip"]}):
                raise AssertionError(f"DSB factory built {type(ds).__name__}")
            ds.transform = AugmentationPipeline(*ds.transform.augmentations, seed=0)
        for i in range(4):
            np.random.seed(i)
            a = by_list[i]
            np.random.seed(i)
            b = by_glob[i]
            if not all(np.array_equal(u, v) for u, v in zip(a, b)) or a[0].shape != DSB_PATCH:
                raise AssertionError("the file-list and folder-glob DSB datasets differ")
        log(f"DSB: file-list and folder-glob datasets give equal samples {a[0].shape}, {a[1].shape}")

        np.random.seed(2)
        model = port.UNet2d(**DSB_MODEL, depth=DSB_DEPTH, device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "dsb", model, loader(DSB_BATCH * DSB_FIT, True), loader(DSB_BATCH, False),
            learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True, logger=LossLog, save_root=tmp)
        resumed, launches = fit_and_resume(port, inorm, trainer, DSB_FIT, DSB_RESUME, 1, "DSB recipe")
        if type(resumed.train_loader.dataset).__name__ != "ImageCollectionDataset":
            raise AssertionError("from_checkpoint did not rebuild the DSB loader")
        rate = loader_rate(resumed, loader(DSB_BATCH * (LOADER_STEPS + 2), True), steps=LOADER_STEPS)
        log(f"DSB loader, {LOADER_THREADS} threads, feeding steps: {rate:.2f} patches/s "
            f"({rate / DSB_BATCH:.2f} batches/s)")
        x, y = bare_step(resumed, loader(DSB_BATCH, False), "DSB")
        device_breakdown("DSB training step (bf16 forward, backward, AdamW)", lambda: resumed._train_step(x, y))
        del trainer, resumed, model, x, y
        torch.cuda.empty_cache()
        run_cli(tmp)
    return launches


def run_cli(tmp):
    """``train_2d_unet`` for DSB_CLI_ITERATIONS iterations on the DSB folders, then
    ``predict_with_tiling`` on its checkpoint into a ``.npy`` file, each in a subprocess."""
    def cli(entry, args):
        code = (f"import sys; sys.argv = ['{entry}'] + {args!r}\n"
                f"from torch_em_tpu_torch.cli import {entry}\n{entry}()\n")
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=tmp, env=env, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{entry} failed: {proc.stderr[-3000:]}")
        last = (proc.stdout.strip().splitlines() or ["(no output)"])[-1]
        log(f"{entry} ran in {time.perf_counter() - t:.1f} s: {last}")

    cli("train_2d_unet", ["-i", os.path.join(tmp, "images"), "-l", os.path.join(tmp, "masks"),
                          "-k", "*.npy", "--training_label_key", "*.npy", "-b", str(DSB_BATCH),
                          "-p", *map(str, DSB_PATCH), "-n", str(DSB_CLI_ITERATIONS),
                          "-m", "boundaries_and_foreground", "--name", "dsb-cli"])
    volume = np.stack([np.load(os.path.join(tmp, "images", f"{i:02d}.npy"))[:200, :240] for i in range(2)])
    np.save(os.path.join(tmp, "volume.npy"), volume)
    cli("predict_with_tiling", ["-c", os.path.join(tmp, "checkpoints", "dsb-cli"), "-i",
                                os.path.join(tmp, "volume.npy"), "-o", os.path.join(tmp, "out.npy"),
                                "--output_key", "pred", "-b", "1", "128", "128", "--halo", "0", "16", "16"])
    out = np.load(os.path.join(tmp, "out.npy"))
    if out.shape != (2,) + volume.shape or not np.isfinite(out).all():  # the CLI's model has no activation
        raise AssertionError(f"predict_with_tiling wrote {out.shape}, finite: {np.isfinite(out).all()}")
    log(f"predict_with_tiling wrote {out.shape} {out.dtype}, finite, in [{out.min():.3f}, {out.max():.3f}]")


def main():
    log("start")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs one NVIDIA card",
              file=sys.stderr, flush=True)
        return 2
    try:
        import torch_em_tpu_torch as port
        import torch_em_tpu_torch.models.unet as unet_module
        import torch_em_tpu_torch.ops.device as device_ops
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

        log("phase 3: forward kernel against its plain version, serving and training shapes")
        block = tuple(b + 2 * h for b, h in zip(BLOCK_SHAPE, HALO))
        shapes = norm_shapes(block, TRACKED["scale_factors"], TRACKED["initial_features"])
        train_shapes = norm_shapes(TRAIN_PATCH, TRACKED["scale_factors"], TRACKED["initial_features"])
        dsb_shapes = norm_shapes(DSB_PATCH[1:], [[2, 2]] * DSB_DEPTH, DSB_MODEL["initial_features"])
        assert len(shapes) == len(train_shapes) == len(dsb_shapes) == NORMS_PER_FORWARD
        forward = phase_norm_kernel(inorm, shapes, train_shapes, dsb_shapes)

        log("phase 4: serving path, tiled AnisotropicUNet inference")
        serving_launches = phase_main_path(port, inorm, unet_module)

        log("phase 5: backward kernel against its plain version, training and serving shapes")
        backward, forward["training"], forward["dsb_training"] = phase_backward_kernel(
            inorm, train_shapes, shapes, dsb_shapes)

        log("phase 6: training path, default_segmentation_trainer on the tracked model")
        train_fwd, train_bwd = phase_training(port, inorm, device_ops)

        log("phase 7: the 3-D recipe through default_segmentation_loader")
        recipe_fwd, recipe_bwd = phase_factory_3d(port, inorm, device_ops)

        log("phase 8: AugmentationPipeline.apply_batched on the card against the CPU")
        phase_apply_batched(port)

        log("phase 9: the DSB recipe, UNet2d at DSB width, and the CLI")
        dsb_fwd, dsb_bwd = phase_dsb(port, inorm)
        forward["launches"] = serving_launches + train_fwd + recipe_fwd + dsb_fwd
        backward["launches"] = train_bwd + recipe_bwd + dsb_bwd
        log(f"forward kernel launches: {serving_launches} serving + {train_fwd} training + {recipe_fwd} "
            f"3-D recipe + {dsb_fwd} DSB; backward kernel launches: {train_bwd} training + {recipe_bwd} "
            f"3-D recipe + {dsb_bwd} DSB")
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
