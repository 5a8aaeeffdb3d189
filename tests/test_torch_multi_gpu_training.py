"""The port's multi-process training: ``train_multi_gpu``, the sharded checkpoint and the
spatially sharded step on a 2-D mesh.

Processes are spawned as in ``test_torch_parallel.py`` (gloo, a ``file://``
store in the test's temporary directory, bodies in
``torch_parallel_workers.py``). The 2x2 step is held against the JAX step on
a 2x2 mesh of the host's CPU devices with the tolerances of
``test_torch_parallel.py``; the rest is the port's own: a checkpoint restored
bitwise, ``train_multi_gpu`` fitting 4 iterations on 2 processes with rank 0
alone writing, and ``DefaultTrainer.from_checkpoint`` resuming that run in a
process group of one.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_parallel as parity
import torch_parallel_workers as workers
import torch_em_tpu_torch as port
from torch_em_tpu.parallel import get_mesh as jax_mesh
from torch_em_tpu_torch.parallel import DataParallelTrainer, init_process_group, train_multi_gpu
from torch_em_tpu_torch.multi_gpu_training import train_multi_device


@pytest.fixture(scope="module")
def mesh2d(tmp_path_factory):
    """The 2x2 step and the checkpoint round trip in one group of 4 processes."""
    folder = tmp_path_factory.mktemp("mesh2d")
    x, y = parity._spatial_inputs(2, 30)
    spatial = {"norm": None, "batch": 2, "batch_axis": "data", "x": x, "y": y, "state": parity._port_state(None, 2)}
    checkpoint = {"state": workers.unet("InstanceNorm", 2).state_dict(), "path": str(folder / "state")}
    data = {"spatial": {"dp_space": spatial}, "checkpoint": checkpoint}
    return data, workers.spawn(str(folder), data, ["spatial", "checkpoint"], world=4)


def test_spatial_sharded_train_step_with_batch_axis_matches_jax(mesh2d):
    """A 2x2 ("data", "space") mesh of 4 processes: the batch of 2 split over "data", the planes
    over "space", the loss and gradients reduced over both; against JAX's 2x2 mesh."""
    data, results = mesh2d
    case, got = data["spatial"]["dp_space"], results["spatial"]["dp_space"]
    mesh = jax_mesh(n_devices=4, axis_names=("data", "space"), shape=(2, 2))
    loss, grads = parity._jax_spatial_grads(None, case["x"], case["y"], mesh, batch_axis="data")
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    parity._check_grads(got["grads"], grads)


def test_sharded_checkpoint_round_trip(mesh2d):
    """A model's and its AdamW state's sharded checkpoint, written by 4 processes together and
    read back onto each process's device: every tensor and value bitwise equal."""
    _, results = mesh2d
    got = results["checkpoint"]
    assert got["equal"] and got["n_tensors"] > 0
    assert ".metadata" in got["files"] and any(f.endswith(".distcp") for f in got["files"])


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 1, 32, 32), dtype=np.float32)
    y = (rng.random((n, 2, 32, 32)) > 0.5).astype(np.float32)
    return x, y


def test_train_multi_gpu_fits_with_rank0_writing_and_resumes(tmp_path):
    """4 iterations over 2 processes (8 training samples, batch 1: 4 per process and epoch), the
    checkpoints written by rank 0 alone; then from_checkpoint rebuilds the DataParallelTrainer and
    fits 2 more iterations in a process group of one."""
    assert train_multi_gpu is train_multi_device
    (x, y), (xv, yv) = _data(8, 0), _data(2, 1)
    log = tmp_path / "log"
    log.mkdir()
    model_kwargs = dict(in_channels=1, out_channels=2, depth=2, initial_features=4, final_activation="Sigmoid",
                        device="cpu")
    train_multi_gpu(port.UNet2d, model_kwargs, workers.array_loader, dict(x=x, y=y, batch_size=1),
                    workers.array_loader, dict(x=xv, y=yv, batch_size=1), iterations=4,
                    trainer_callable=workers.WriteLog(str(log)), n_devices=2, device="cpu", name="multi",
                    save_root=str(tmp_path), mixed_precision=False, logger=None)
    folder = tmp_path / "checkpoints" / "multi"
    assert sorted(os.listdir(log)) == ["writes-rank0.txt"]
    written = set((log / "writes-rank0.txt").read_text().split())
    assert written == {str(folder / "best.ckpt"), str(folder / "latest.ckpt")}
    saved = torch.load(folder / "latest.ckpt", weights_only=False)
    assert saved["iteration"] == 4 and saved["epoch"] == 0  # one epoch of 4 batches per process

    init_process_group(f"file://{tmp_path / 'store'}", 1, 0, device="cpu", backend="gloo")
    try:
        trainer = port.DefaultTrainer.from_checkpoint(str(folder), "latest", device="cpu")
        assert isinstance(trainer, DataParallelTrainer) and trainer.iteration == 4
        for key, value in trainer.model.state_dict().items():
            assert torch.equal(value, saved["model_state"][key]), key
        trainer.fit(iterations=2)
    finally:
        dist.destroy_process_group()
    assert trainer.iteration == 6
    assert torch.load(folder / "latest.ckpt", weights_only=False)["iteration"] == 6
