"""Data-parallel training: one process per device, gradients all-reduced by DDP.

Counterpart of ``torch_em_tpu/parallel/data_parallel.py``, whose single
process replicates the parameters over a mesh and shards each batch, so that
a step over N devices is the step over the whole batch. The port runs
torch-em's model instead (``multi_gpu_training.py``): N processes, each
holding a replica in ``DistributedDataParallel`` and its share of the batch,
and it keeps the JAX step's result, the step over the whole batch:

- a loss with the shard protocol (``shard_parts``/``loss_from_parts``, the
  Dice losses) is formed from its parts summed over the processes by the
  autograd ``all_reduce``, so it is the Dice of the whole batch, not the mean
  of each process's Dice. That ``all_reduce``'s backward sums the gradient of
  the (equal) loss over the N processes, and DDP then averages the parameter
  gradients over them: the two factors of N cancel. A loss without the
  protocol is each process's own, and DDP's average gives the gradient of
  their mean, as the JAX package does for such losses;
- the U-Net's ``BatchNorm`` (and the running statistics of
  ``InstanceNormTrackStats``) reduce their batch statistics over the group;
- a batch that does not divide the processes is padded by repeating samples
  (``mesh.shard_batch``).

Only rank 0 writes checkpoints and logs. Each process validates on its own
validation loader and the processes average the metric, so the scheduler and
early stopping decide alike everywhere.

``train_multi_device`` (alias ``train_multi_gpu``) spawns the processes,
builds the model and loaders from callables in each, shards the training
data with ``DistributedIndexSampler`` and fits a ``DataParallelTrainer``.
"""

import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.nn.parallel import DistributedDataParallel

from ..data.loader import DistributedIndexSampler
from ..models.unet import _AffineNorm
from ..trainer.default_trainer import DefaultTrainer
from .mesh import _axis_group, _comm_device, default_backend, get_mesh, init_process_group, shard_batch

__all__ = ["DataParallelTrainer", "train_multi_device", "train_multi_gpu", "global_loss", "has_shard_protocol"]


def has_shard_protocol(loss) -> bool:
    return hasattr(loss, "shard_parts") and hasattr(loss, "loss_from_parts")


def global_loss(loss, pred, y, group=None):
    """The loss of the whole batch that ``group``'s processes hold between them, from the
    parts of a loss with the shard protocol summed with the autograd ``all_reduce``."""
    from torch.distributed.nn.functional import all_reduce

    parts = loss.shard_parts(pred, y)
    return loss.loss_from_parts({k: all_reduce(v, group=group) for k, v in parts.items()})


class DataParallelTrainer(DefaultTrainer):
    """``DefaultTrainer`` over the processes of a group, one device each.

    Runs in a process group joined before ``fit`` (``parallel.init_process_group``, or
    ``train_multi_device``); ``mesh`` (default: a 1-D ``("data",)`` mesh over the group)
    gives the data axis. The model is wrapped in ``DistributedDataParallel`` on this
    process's device. A training loader with a sampler gives this process's batches
    already; from any other each process takes its slice of every batch.
    """

    def __init__(self, *args, mesh=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh = mesh
        self.ddp = None
        self.group = None

    def _initialize(self, iterations, load_from_checkpoint, epochs=None):
        if not dist.is_initialized():
            raise RuntimeError("DataParallelTrainer runs in a process group: join one with "
                               "parallel.init_process_group, or train through train_multi_device")
        if self.mesh is None:
            self.mesh = get_mesh()
        self.group, self.n_devices, _ = _axis_group(self.mesh, "data")
        self.rank = dist.get_rank()
        if self.rank != 0:
            self.logger_class = None
        for m in self.model.modules():
            if isinstance(m, _AffineNorm):
                m.process_group = self.group
        best_metric = super()._initialize(iterations, load_from_checkpoint, epochs)
        if self.ddp is None:
            # DDP copies rank 0's parameters and buffers to every process; the norms'
            # running statistics stay equal without the per-forward buffer broadcast
            self.ddp = DistributedDataParallel(self.model, process_group=self.group, broadcast_buffers=False)
        return best_metric

    def _compute_loss(self, x, y, generator=None):
        if not torch.is_grad_enabled():  # validation: this process's replica on its own data
            return super()._compute_loss(x, y, generator)
        if self.device_label_transform is not None:
            y = self.device_label_transform(y)
        with self._compute_precision():
            pred = self.ddp(x)
        if has_shard_protocol(self.loss):
            return global_loss(self.loss, pred, y, self.group), pred
        return self._loss_value(self.loss, pred, y, generator), pred

    def _train_batches(self):
        if getattr(self.train_loader, "sampler", None) is not None:
            yield from super()._train_batches()
            return
        for x, y in self.train_loader:
            x, y = shard_batch((x, y), self.mesh, "data")
            yield self._to_device(x), self._to_device(y)

    def _validate(self):
        metric = torch.tensor(super()._validate(), dtype=torch.float64, device=_comm_device(self.group))
        dist.all_reduce(metric, group=self.group)
        return float(metric) / self.n_devices


def _train_worker(rank, world_size, init_method, device, backend, model_callable, model_kwargs,
                  train_loader_callable, train_loader_kwargs, val_loader_callable, val_loader_kwargs,
                  iterations, trainer_callable, trainer_kwargs):
    """One process of ``train_multi_device``."""
    dev = init_process_group(init_method, world_size, rank, device=device, backend=backend)
    try:
        model = model_callable(**model_kwargs)
        train_loader = train_loader_callable(**train_loader_kwargs)
        train_loader.sampler = DistributedIndexSampler(len(train_loader.dataset), world_size, rank)
        val_loader = val_loader_callable(**val_loader_kwargs)
        if trainer_callable is None:
            from ..segmentation import default_segmentation_trainer as trainer_callable
        trainer = trainer_callable(model=model, train_loader=train_loader, val_loader=val_loader,
                                   trainer_class=DataParallelTrainer, device=dev, rank=rank, **trainer_kwargs)
        trainer.fit(iterations)
    finally:
        dist.destroy_process_group()


def train_multi_device(
    model_callable: Callable,
    model_kwargs: Dict[str, Any],
    train_loader_callable: Callable,
    train_loader_kwargs: Dict[str, Any],
    val_loader_callable: Callable,
    val_loader_kwargs: Dict[str, Any],
    iterations: int,
    trainer_callable: Optional[Callable] = None,
    n_devices: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    backend: Optional[str] = None,
    **trainer_kwargs,
):
    """Data-parallel training over ``n_devices`` processes (reference ``train_multi_gpu``).

    The model and the loaders are built in each process from a callable and its keyword
    arguments, which must pickle (functions of a module, not lambdas). ``trainer_callable``
    (default ``default_segmentation_trainer``) takes ``model``, ``train_loader``,
    ``val_loader``, ``trainer_class``, ``device``, ``rank`` and ``trainer_kwargs``. Process
    ``r`` runs on ``rank_device(r, device)``: card ``r`` on a machine of ``n_devices``
    cards (the default count), or the CPU with ``device="cpu"`` (one process unless
    ``n_devices`` says more). ``backend`` defaults to NCCL on the card and gloo on the CPU;
    gloo lets several processes share one card. Rank 0 writes the checkpoints, under
    ``save_root/checkpoints/<name>`` as ``DefaultTrainer`` does, and
    ``DefaultTrainer.from_checkpoint`` rebuilds the ``DataParallelTrainer`` (to fit on, in a
    process group). Raises if any process fails.
    """
    device = torch.device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    backend = backend or default_backend(device)
    store = tempfile.mkdtemp(prefix="tem_dist_")
    try:
        mp.spawn(_train_worker, nprocs=n_devices, join=True, args=(
            n_devices, f"file://{os.path.join(store, 'store')}", str(device), backend,
            model_callable, model_kwargs, train_loader_callable, train_loader_kwargs,
            val_loader_callable, val_loader_kwargs, iterations, trainer_callable, trainer_kwargs))
    finally:
        shutil.rmtree(store, ignore_errors=True)


# the reference's name
train_multi_gpu = train_multi_device
