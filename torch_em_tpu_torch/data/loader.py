"""Host data loader: batched, shuffling, prefetching batch assembly.

Counterpart of ``torch_em_tpu/data/loader.py`` with its constructor
arguments, ``set_epoch`` and ``len()`` (the number of batches). Batches are
assembled on the host, in the calling thread or, with ``num_workers > 0``,
by a pool of threads with ``prefetch_factor * num_workers`` batches in
flight; numpy reads of memory-mapped volumes and most numpy transforms
release the interpreter lock. A batch is a tuple of CPU tensors stacked
from the samples' numpy arrays; the trainer moves it to its device.

Threads share the global ``np.random`` that ``SegmentationDataset`` draws
from, so one stream of draws serves all of them; the draws land in sample
order only with ``num_workers=0``.

``worker_mode="process"`` assembles batches in a persistent pool of
``num_workers`` spawned processes instead, for label transforms that hold
the interpreter lock. Each worker unpickles the dataset and the collate
function once, when the pool starts (later changes to either reach the
workers only after ``shutdown``), and sends its batches back as numpy
arrays, which the loader turns into tensors. A worker process seeds its own
``np.random``, so random crops differ from the thread workers' unless the
dataset's draws are fixed.

``DistributedIndexSampler`` gives each of several processes its share of the
indices, as torch's ``DistributedSampler`` does; for one seed and epoch the
indices are those of the JAX package's sampler, bit for bit.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["DataLoader", "default_collate", "DistributedIndexSampler"]

# the dataset and collate function of a worker process (set by _process_worker_init)
_WORKER_STATE: dict = {}


def _process_worker_init(dataset, collate_fn):
    _WORKER_STATE["dataset"] = dataset
    _WORKER_STATE["collate"] = collate_fn


def _map_batch(batch, fn, kind):
    """``fn`` applied to every ``kind`` leaf of a batch (a leaf or a tuple or list of leaves)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map_batch(b, fn, kind) for b in batch)
    return fn(batch) if isinstance(batch, kind) else batch


def _process_load_batch(batch_indices):
    ds = _WORKER_STATE["dataset"]
    batch = _WORKER_STATE["collate"]([ds[int(i)] for i in batch_indices])
    return _map_batch(batch, lambda t: t.numpy(), torch.Tensor)


def default_collate(samples):
    """Stack per-sample numpy arrays (or tuples of arrays) into batched tensors."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(torch.from_numpy(np.stack([np.asarray(s[i]) for s in samples]))
                     for i in range(len(first)))
    return torch.from_numpy(np.stack([np.asarray(s) for s in samples]))


class DistributedIndexSampler:
    """This process's share of ``n`` indices among ``num_replicas``: a permutation seeded by
    ``seed + epoch`` (or the identity without ``shuffle``), padded by its own start to a
    multiple of ``num_replicas``, every ``num_replicas``-th index from ``rank`` on."""

    def __init__(self, n: int, num_replicas: int, rank: int, shuffle: bool = True, seed: int = 0):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} is not one of {num_replicas} replicas")
        self.n = n
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = int(np.ceil(n / num_replicas))

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(self.n)
        else:
            order = np.arange(self.n)
        total = self.num_samples * self.num_replicas
        if total > self.n:
            order = np.concatenate([order, order[: total - self.n]])
        return order[self.rank: total: self.num_replicas]


class DataLoader:
    """Batched, shuffling, prefetching loader over a map-style dataset.

    ``batch_size``, ``shuffle`` (a mutable attribute), ``num_workers``,
    ``drop_last``, ``collate_fn``, ``prefetch_factor`` and ``seed`` (of the
    shuffling ``np.random.default_rng``) mean what they mean in the JAX
    package. With ``seed=None`` each epoch's permutation comes from a seed
    drawn from torch's global generator, as torch's ``RandomSampler`` draws
    it, so ``torch.manual_seed`` fixes the order. A ``sampler`` (a
    ``DistributedIndexSampler``) chooses the indices instead, and ``len()``
    counts its share. ``worker_mode`` is "thread" or "process". Other torch
    DataLoader keyword arguments are accepted and unused.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 0,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        prefetch_factor: int = 2,
        seed: Optional[int] = None,
        sampler: Optional[DistributedIndexSampler] = None,
        worker_mode: str = "thread",
        **unused_torch_kwargs,
    ):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', got {worker_mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.prefetch_factor = prefetch_factor
        self.sampler = sampler
        self.worker_mode = worker_mode
        self._pool = None
        self._rng = None if seed is None else np.random.default_rng(seed)
        self.init_kwargs = {
            "batch_size": batch_size, "shuffle": shuffle, "num_workers": num_workers,
            "drop_last": drop_last, "prefetch_factor": prefetch_factor, "worker_mode": worker_mode,
        }

    def _process_pool(self):
        """The persistent pool of spawned workers, started at first use."""
        if self._pool is None:
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_process_worker_init, initargs=(self.dataset, self.collate_fn))
        return self._pool

    def shutdown(self):
        """Stop the worker processes (process mode); the next epoch starts new ones."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)

    def set_epoch(self, epoch: int):
        """Called by the trainer before each epoch; passed on to the sampler."""
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset) if self.sampler is None else self.sampler.num_samples
        if self.drop_last:
            return n // self.batch_size
        return int(np.ceil(n / self.batch_size))

    def _batches(self):
        idx = np.arange(len(self.dataset)) if self.sampler is None else self.sampler.indices()
        if self.shuffle and self.sampler is None:
            if self._rng is None:
                seed = int(torch.empty((), dtype=torch.int64).random_().item())
                idx = torch.randperm(len(idx), generator=torch.Generator().manual_seed(seed)).numpy()
            else:
                idx = self._rng.permutation(idx)
        batches = [idx[i: i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def _load_batch(self, batch_indices):
        return self.collate_fn([self.dataset[int(i)] for i in batch_indices])

    def __iter__(self):
        batches = self._batches()
        if self.num_workers <= 0:
            return (self._load_batch(b) for b in batches)
        if self.worker_mode == "process":
            return (_map_batch(b, torch.from_numpy, np.ndarray)
                    for b in self._prefetched(self._process_pool(), _process_load_batch, batches))
        return self._threaded(batches)

    def _threaded(self, batches):
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            yield from self._prefetched(pool, self._load_batch, batches)

    def _prefetched(self, pool, load, batches):
        """``load(b)`` of each batch in order, ``prefetch_factor * num_workers`` in flight."""
        depth = max(self.prefetch_factor, 1) * self.num_workers
        futures = [pool.submit(load, b) for b in batches[:depth]]
        for i in range(len(batches)):
            if i + depth < len(batches):
                futures.append(pool.submit(load, batches[i + depth]))
            yield futures[i].result()
            futures[i] = None
