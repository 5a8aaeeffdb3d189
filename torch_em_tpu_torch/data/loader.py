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
order only with ``num_workers=0``. The JAX package's process workers
(``worker_mode="process"``) and its ``DistributedIndexSampler`` wait for the
port of ``parallel/``.
"""

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["DataLoader", "default_collate"]


def default_collate(samples):
    """Stack per-sample numpy arrays (or tuples of arrays) into batched tensors."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(torch.from_numpy(np.stack([np.asarray(s[i]) for s in samples]))
                     for i in range(len(first)))
    return torch.from_numpy(np.stack([np.asarray(s) for s in samples]))


class DataLoader:
    """Batched, shuffling, prefetching loader over a map-style dataset.

    ``batch_size``, ``shuffle`` (a mutable attribute), ``num_workers``,
    ``drop_last``, ``collate_fn``, ``prefetch_factor`` and ``seed`` (of the
    shuffling ``np.random.default_rng``) mean what they mean in the JAX
    package. With ``seed=None`` each epoch's permutation comes from a seed
    drawn from torch's global generator, as torch's ``RandomSampler`` draws
    it, so ``torch.manual_seed`` fixes the order. Other torch DataLoader
    keyword arguments are accepted and unused.
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
        worker_mode: str = "thread",
        **unused_torch_kwargs,
    ):
        if worker_mode != "thread":
            raise NotImplementedError(
                f"worker_mode={worker_mode!r} is not ported yet; the port's loader runs threads")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.prefetch_factor = prefetch_factor
        self._rng = None if seed is None else np.random.default_rng(seed)
        self.init_kwargs = {
            "batch_size": batch_size, "shuffle": shuffle, "num_workers": num_workers,
            "drop_last": drop_last, "prefetch_factor": prefetch_factor, "worker_mode": worker_mode,
        }

    def set_epoch(self, epoch: int):
        """Called by the trainer before each epoch; a no-op until the
        per-epoch ``DistributedIndexSampler`` is ported."""

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return int(np.ceil(n / self.batch_size))

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
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
        return self._prefetched(batches)

    def _prefetched(self, batches):
        depth = max(self.prefetch_factor, 1) * self.num_workers
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = [pool.submit(self._load_batch, b) for b in batches[:depth]]
            for i in range(len(batches)):
                if i + depth < len(batches):
                    futures.append(pool.submit(self._load_batch, batches[i + depth]))
                yield futures[i].result()
                futures[i] = None
