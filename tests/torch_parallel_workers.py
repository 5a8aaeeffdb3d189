"""Process bodies for the port's multi-process tests (``test_torch_parallel.py``,
``test_torch_loader_workers.py``).

Each test spawns its processes with ``run``: they join a gloo group through a
``file://`` store in the test's temporary directory, compute on the CPU, and
rank 0 saves what the test compares. This module imports torch, numpy and the
port only, so the spawned processes import nothing of JAX.
"""

import os
import uuid

import numpy as np
import torch
import torch.distributed as dist

import torch_em_tpu_torch as port
from torch_em_tpu_torch.parallel import (get_mesh, halo_sharded_predict, halo_sharded_predict_large,
                                         init_process_group, restore_sharded_checkpoint, save_sharded_checkpoint,
                                         shard_batch, spatial_sharded_train_step)
from torch_em_tpu_torch.parallel.data_parallel import DataParallelTrainer
from torch_em_tpu_torch.parallel.halo import _extend

UNET = dict(in_channels=1, depth=2, initial_features=4, final_activation="Sigmoid", device="cpu")
DP_LR = 1e-2


class ArrayDataset:
    """(x[i], y[i]) of two arrays, the samples of a loader whose batches the test fixes."""

    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class SeededDataset:
    """Sample i: seeded normal values of ``shape`` and the index, the same in any process."""

    def __init__(self, n, shape):
        self.n, self.shape = n, shape

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.random.default_rng(i).normal(size=self.shape).astype(np.float32), np.array([i], dtype=np.int64)


def array_loader(x, y, batch_size):
    return port.DataLoader(ArrayDataset(x, y), batch_size=batch_size)


def unet(norm, out_channels, state=None):
    model = port.UNet2d(out_channels=out_channels, norm=norm, **UNET)
    if state is not None:
        model.load_state_dict(state)
    return model


def dp_trainer(model, x, y, save_root, trainer_class=DataParallelTrainer):
    loader = port.DataLoader(ArrayDataset(x, y), batch_size=len(x))
    return trainer_class(
        name="dp", model=model, train_loader=loader, val_loader=loader, loss=port.DiceLoss(),
        metric=port.DiceLoss(), optimizer=port.OptimizerSpec("sgd", lr=DP_LR), mixed_precision=False,
        device="cpu", logger=None, save_root=save_root)


def task_dp_step(rank, world, data):
    """One DataParallelTrainer step for each case of ``data["dp"]``: the loss and the state."""
    out = {}
    for name, case in data["dp"].items():
        trainer = dp_trainer(unet(case["norm"], case["y"].shape[1], case["state"]), case["x"], case["y"],
                             data["folder"])
        trainer._initialize(1, None)
        trainer.model.train()  # as _train_epoch sets it
        x, y = shard_batch((torch.from_numpy(case["x"]), torch.from_numpy(case["y"])), trainer.mesh)
        loss, _ = trainer._train_step(x, y)
        out[name] = {"loss": float(loss), "state": {k: v.clone() for k, v in trainer.model.state_dict().items()},
                     "rank": trainer.rank}
    return out


def task_halo(rank, world, data):
    """halo_sharded_predict (norm-free and InstanceNorm, derived halo) and
    halo_sharded_predict_large at an odd extent, along a 1-D ("space",) mesh."""
    mesh = get_mesh(axis_names=("space",))
    out = {}
    for name, case in data["halo"].items():
        model = unet(case["norm"], 2, case["state"]).eval()
        if "chunk" in case:
            out[name] = halo_sharded_predict_large(model, case["volume"], mesh, chunk=case["chunk"])
        else:
            out[name] = halo_sharded_predict(model, case["volume"], mesh, halo=case.get("halo"))
    return out


def task_exchange_grad(rank, world, data):
    """The gradient of sum(w * extended slab) w.r.t. this process's slab, slabs along axis 2."""
    mesh = get_mesh(axis_names=("space",))
    case = data["exchange"]
    x, w, halo = torch.from_numpy(case["x"]), torch.from_numpy(case["w"]), case["halo"]
    s = x.shape[2] // world
    local = x[:, :, rank * s:(rank + 1) * s].clone().requires_grad_(True)
    ext = _extend(local, halo, 2, mesh.get_group("space"))
    (ext * w[rank]).sum().backward()
    grads = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(grads, local.grad)
    return torch.cat(grads, dim=2).numpy()


def task_spatial(rank, world, data):
    """One spatial_sharded_train_step (SGD at lr 1) for each case: the loss and the gradients."""
    out = {}
    for name, case in data["spatial"].items():
        if case.get("batch_axis"):
            mesh = get_mesh(axis_names=("data", "space"), shape=(2, world // 2))
        else:
            mesh = get_mesh(axis_names=("space",))
        model = unet(case["norm"], 2, case["state"])
        step, shard = spatial_sharded_train_step(model, port.DiceLoss(), port.OptimizerSpec("sgd", lr=1.0), mesh,
                                                 batch_axis=case.get("batch_axis"))
        loss = step(*shard(case["x"], case["y"]))
        out[name] = {"loss": float(loss), "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}
    return out


def task_checkpoint(rank, world, data):
    """A sharded checkpoint of a model and its AdamW state, restored: bitwise equal."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model = unet("InstanceNorm", 2, data["checkpoint"]["state"])
    optimizer = port.OptimizerSpec("adamw", lr=1e-3).build(model.parameters())
    model(torch.ones(1, 1, 16, 16)).sum().backward()
    optimizer.step()
    model_state, optim_state = get_state_dict(model, optimizer)
    tree = {"model": model_state, "optimizer": optim_state, "iteration": 7}
    path = save_sharded_checkpoint(data["checkpoint"]["path"], tree)
    restored = restore_sharded_checkpoint(path, tree, mesh=get_mesh())
    flat, back = _leaves(tree), _leaves(restored)
    equal = flat.keys() == back.keys() and all(
        torch.equal(v, back[k]) if isinstance(v, torch.Tensor) else v == back[k] for k, v in flat.items())
    files = sorted(os.listdir(path))
    return {"equal": equal, "files": files, "n_tensors": sum(isinstance(v, torch.Tensor) for v in flat.values())}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


TASKS = {"dp_step": task_dp_step, "halo": task_halo, "exchange_grad": task_exchange_grad, "spatial": task_spatial,
         "checkpoint": task_checkpoint}


def run(rank, world, folder, store, tasks):
    """The body of one process: join the group through the file ``store``, run ``tasks`` on the
    inputs the test saved in ``folder``, rank 0 saving their results there."""
    init_process_group(f"file://{store}", world, rank, device="cpu", backend="gloo")
    torch.set_num_threads(1)
    try:
        data = torch.load(os.path.join(folder, "inputs.pt"), weights_only=False)
        results = {}
        for task in tasks:
            results[task] = TASKS[task](rank, world, data)
        if rank == 0:
            torch.save(results, os.path.join(folder, "results.pt"))
    finally:
        dist.destroy_process_group()


def spawn(folder, data, tasks, world=2):
    """Run ``tasks`` in ``world`` processes on ``data``; returns rank 0's results, {task: result}."""
    torch.save({**data, "folder": folder}, os.path.join(folder, "inputs.pt"))
    store = os.path.join(folder, f"store-{uuid.uuid4().hex}")
    torch.multiprocessing.spawn(run, args=(world, folder, store, tasks), nprocs=world, join=True)
    return torch.load(os.path.join(folder, "results.pt"), weights_only=False)


class WriteLog:
    """A ``trainer_callable`` for ``train_multi_gpu`` that notes in ``folder`` every checkpoint
    file each rank writes."""

    def __init__(self, folder):
        self.folder = folder

    def __call__(self, **kwargs):
        trainer = port.default_segmentation_trainer(**kwargs)
        save, log = torch.save, os.path.join(self.folder, f"writes-rank{kwargs['rank']}.txt")

        def logged(obj, path, *args, **kw):
            with open(log, "a") as f:
                f.write(f"{path}\n")
            return save(obj, path, *args, **kw)

        torch.save = logged
        return trainer

