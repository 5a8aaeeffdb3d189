"""Profiling helpers: ``torch.profiler`` traces, a step's FLOPs and the model FLOPs utilisation.

Counterpart of ``torch_em_tpu/utils/profiling.py``. ``trace`` (or
``start_trace`` / ``stop_trace``) records the CPU and, where there is a card,
the CUDA activity of a block into a Chrome trace (``chrome://tracing`` or
Perfetto). ``estimate_step_flops`` counts the FLOPs of one call with
``torch.utils.flop_counter.FlopCounterMode``: the matrix products,
convolutions and attentions, forward and backward; elementwise work and the
port's own kernels count nothing. ``peak_flops`` knows the dense bfloat16
peak of the cards in ``_PEAK_BF16`` and returns None for any other device.
"""

import contextlib
import os
import time
from typing import Callable, Optional, Union

import torch

__all__ = ["trace", "start_trace", "stop_trace", "estimate_step_flops", "peak_flops", "mfu", "StepTimer"]

# dense bfloat16 FLOP/s by CUDA device name: NVIDIA's H100 SXM data sheet, 989 TFLOP/s
# without sparsity, at the card's full 700 W
_PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H100 SXM": 989e12,
}


def start_trace(logdir: str) -> torch.profiler.profile:
    """Start recording CPU and (with a card) CUDA activity; ``stop_trace`` writes it to ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, logdir: str, name: Optional[str] = None) -> str:
    """Stop ``prof`` (waiting for the card) and write its Chrome trace to ``logdir``; returns its path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{name or 'trace-%d' % time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed block into a Chrome trace in ``logdir``."""
    prof = start_trace(logdir)
    try:
        yield prof
    finally:
        stop_trace(prof, logdir)


def estimate_step_flops(fn: Callable, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call of ``fn(*args, **kwargs)``, which runs once under the counter; None when
    it counts none."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops()) or None


def peak_flops(device: Union[str, torch.device, None] = None) -> Optional[float]:
    """Dense bfloat16 peak FLOP/s of a CUDA device (the current one by default); None for the
    CPU or a card not in the table."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return _PEAK_BF16.get(torch.cuda.get_device_name(device))


def mfu(flops_per_step: float, s_per_iter: float, device=None) -> Optional[float]:
    """Model FLOPs utilisation: achieved FLOP/s over the device's bfloat16 peak."""
    peak = peak_flops(device)
    if peak is None or not flops_per_step or not s_per_iter:
        return None
    return (flops_per_step / s_per_iter) / peak


class StepTimer:
    """Running mean and max of step times, after ``warmup`` steps."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.n = 0
        self.total = 0.0
        self.max = 0.0
        self._t = None

    def start(self):
        self._t = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._t
        self.n += 1
        if self.n > self.warmup:
            self.total += dt
            self.max = max(self.max, dt)
        return dt

    @property
    def mean(self):
        return self.total / max(self.n - self.warmup, 1)
