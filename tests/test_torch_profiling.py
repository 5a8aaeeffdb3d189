"""The trainer's profiling remainder: ``fit(progress=..., profile_dir=..., log_mfu=...)`` and
``utils/profiling.py``, on the CPU.

The JAX package's ``fit`` takes the same three arguments: a progress bar that
is updated once per step, a trace of steps 3 to 7 of each epoch, and the
step's FLOPs with the model FLOPs utilisation printed at the end of each
epoch. The port traces with ``torch.profiler`` (Chrome traces) and counts
FLOPs with ``FlopCounterMode`` on the first step; the CPU has no peak, so
the utilisation is "not known" here and a figure on the card.
"""

import glob
import json
import os

import numpy as np
import torch

import torch_em_tpu_torch as port
from torch_em_tpu_torch.loss import ContrastiveLoss, SPOCOLoss
from torch_em_tpu_torch.trainer import SPOCOTrainer
from torch_em_tpu_torch.utils import profiling


class Progress:
    def __init__(self):
        self.updates = []

    def update(self, n):
        self.updates.append(n)


def _loaders(n_train, n_val=1, labels="binary"):
    rng = np.random.default_rng(0)
    raw = rng.normal(size=(4, 32, 32)).astype(np.float32)
    y = (raw > 0).astype(np.float32) if labels == "binary" else (raw > 0).astype(np.int32) * 3
    train = port.SegmentationDataset(raw, None, y, None, patch_shape=(1, 16, 16), ndim=2, n_samples=n_train)
    val = port.SegmentationDataset(raw, None, y, None, patch_shape=(1, 16, 16), ndim=2, n_samples=n_val)
    return port.DataLoader(train, batch_size=1), port.DataLoader(val, batch_size=1)


def _trainer(tmp_path, n_train):
    train, val = _loaders(n_train)
    model = port.UNet2d(1, 1, depth=2, initial_features=4, final_activation="Sigmoid", device="cpu")
    return port.default_segmentation_trainer("profiled", model, train, val, device="cpu", mixed_precision=False,
                                             save_root=str(tmp_path))


def test_fit_traces_counts_progress_and_prints_mfu(tmp_path, capsys):
    trainer = _trainer(tmp_path, n_train=10)
    progress = Progress()
    trainer.fit(iterations=10, progress=progress, profile_dir=str(tmp_path / "profile"), log_mfu=True)
    assert progress.updates == [1] * 10
    traces = glob.glob(str(tmp_path / "profile" / "*.json"))
    assert [os.path.basename(t) for t in traces] == ["trace-iteration3.json"]
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    out = capsys.readouterr().out
    assert trainer._step_flops > 0
    assert f"train step: {trainer._step_flops / 1e9:.1f} GFLOP" in out and "MFU not known" in out


def test_short_epochs_trace_to_their_end(tmp_path):
    """An epoch of 5 steps traces steps 3 and 4; every epoch writes its own trace."""
    trainer = _trainer(tmp_path, n_train=5)
    trainer.fit(iterations=10, profile_dir=str(tmp_path / "profile"))
    names = sorted(os.path.basename(t) for t in glob.glob(str(tmp_path / "profile" / "*.json")))
    assert names == ["trace-iteration3.json", "trace-iteration8.json"]


def test_flops_counted_on_the_first_step_equal_the_steps_flops(tmp_path):
    """The counted step is a real step: the run trains as many steps as without log_mfu, to
    the same weights."""
    counted, plain = _trainer(tmp_path / "a", n_train=3), _trainer(tmp_path / "b", n_train=3)
    for trainer, kwargs in ((counted, {"log_mfu": True}), (plain, {})):
        np.random.seed(0)  # the datasets' crops
        torch.manual_seed(0)  # the loaders' shuffles
        trainer.fit(iterations=3, **kwargs)
    for (name, a), b in zip(counted.model.state_dict().items(), plain.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    x, y = (v for v in next(iter(_loaders(1)[0])))
    assert counted._step_flops == profiling.estimate_step_flops(plain._train_step, x, y)


def test_spoco_trainer_fit_takes_the_profiling_arguments(tmp_path, capsys):
    train, val = _loaders(4, labels="instances")
    model = port.UNet2d(1, 4, depth=2, initial_features=4, device="cpu")
    trainer = SPOCOTrainer(name="spoco", model=model, train_loader=train, val_loader=val,
                           loss=SPOCOLoss(0.75, 2.0), metric=ContrastiveLoss(0.75, 2.0), momentum=0.9,
                           device="cpu", mixed_precision=False, logger=None, save_root=str(tmp_path))
    progress = Progress()
    trainer.fit(iterations=4, progress=progress, profile_dir=str(tmp_path / "profile"), log_mfu=True)
    assert progress.updates == [1] * 4
    assert glob.glob(str(tmp_path / "profile" / "*.json"))
    assert "GFLOP" in capsys.readouterr().out


def test_estimate_step_flops_counts_products():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    assert profiling.estimate_step_flops(torch.matmul, a, b) == 2 * 8 * 16 * 4
    assert profiling.estimate_step_flops(torch.add, a, a) is None


def test_peak_flops_and_mfu():
    assert profiling.peak_flops("cpu") is None
    assert profiling.mfu(1e12, 1.0, "cpu") is None
    if not torch.cuda.is_available():
        assert profiling.peak_flops() is None
    assert profiling._PEAK_BF16["NVIDIA H100 80GB HBM3"] == 989e12


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(4) + 1
    assert len(glob.glob(str(tmp_path / "*.json"))) == 1


def test_step_timer_skips_warmup():
    timer = profiling.StepTimer(warmup=1)
    for _ in range(3):
        timer.start()
        timer.stop()
    assert timer.n == 3 and 0 <= timer.mean <= timer.max
