"""Smoke run of the PyTorch/CUDA port (torch_em_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit. Phases, each announced by a flushed ``[smoke +Ns] <phase>`` line:

1. device report (nvidia-smi name and power limit, torch and CUDA versions);
2. build the port's kernels with nvcc for sm_90a;
3. hold each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, at every shape the main path gives it plus ragged
   and misaligned shapes, and time kernel, plain version and the PyTorch
   library call at the main path's shapes;
4. the main path: the tracked CREMI AnisotropicUNet at full width, bf16
   compute, through ``predict_with_halo`` on a seeded 64x512x512 volume
   with block (32, 512, 512) and halo (4, 32, 32); checks the output, the
   kernel's launch count, and one block against the same model with the
   plain instance norm.

The last three lines are the card's name and power limit, a JSON line with
one entry per kernel, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or when any phase fails, it exits nonzero and prints no result line.
"""

import json
import subprocess
import sys
import time
import traceback
import unittest.mock

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


def time_ms(fn, x, iters=5):
    """Mean device time of ``fn(x)`` over ``iters`` calls, after one warm-up call."""
    fn(x)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(x)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


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
        n = int(np.prod(shape))
        buf = (torch.randn(n + offset, generator=g, device="cuda") * 2 + 0.5).to(dtype)
        return buf[offset:].view(shape)

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
        inorm.load_kernel()
        log(f"built instance_norm.cu in {time.perf_counter() - t:.1f} s")

        log("phase 3: kernels against their plain versions")
        block = tuple(b + 2 * h for b, h in zip(BLOCK_SHAPE, HALO))
        shapes = norm_shapes(block, TRACKED["scale_factors"], TRACKED["initial_features"])
        assert len(shapes) == NORMS_PER_FORWARD
        entry = phase_norm_kernel(inorm, shapes)

        log("phase 4: main path, tiled AnisotropicUNet inference")
        n_blocks = int(np.prod([-(-v // b) for v, b in zip(VOLUME_SHAPE, BLOCK_SHAPE)]))
        entry["launches"] = phase_main_path(port, inorm, unet_module, n_blocks)
    except Exception:
        traceback.print_exc()
        log("FAILED")
        return 1

    print(smi, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
