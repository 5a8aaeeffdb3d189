"""The port's loader across processes: ``DistributedIndexSampler`` and the process workers.

The sampler's indices for a seed, an epoch and a rank must be the JAX
package's, bit for bit (both draw from ``np.random.default_rng(seed +
epoch)``). Process workers (``worker_mode="process"``, a persistent pool of
spawned processes) must give the batches that thread workers give, and the
JAX package's loader gives, over a dataset whose samples are the same in any
process (``torch_parallel_workers.SeededDataset``), shuffled by a seed and
sharded by the sampler, across two epochs; and they must restart after
``shutdown``.
"""

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from torch_em_tpu.data.loader import DataLoader as JaxDataLoader, DistributedIndexSampler as JaxSampler
from torch_em_tpu_torch.data import DataLoader, DistributedIndexSampler


@pytest.mark.parametrize("n,replicas,shuffle", [(10, 2, True), (10, 3, True), (7, 4, False), (5, 8, True)])
def test_sampler_indices_match_jax(n, replicas, shuffle):
    for epoch in range(3):
        for rank in range(replicas):
            ours, theirs = (cls(n, replicas, rank, shuffle=shuffle, seed=5) for cls in (DistributedIndexSampler,
                                                                                         JaxSampler))
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            np.testing.assert_array_equal(ours.indices(), theirs.indices())
            assert ours.num_samples == theirs.num_samples == len(ours.indices())
    shares = [DistributedIndexSampler(n, replicas, r, shuffle=shuffle).indices() for r in range(replicas)]
    assert set(np.concatenate(shares)) == set(range(n))
    with pytest.raises(ValueError, match="rank"):
        DistributedIndexSampler(n, replicas, replicas)


def _batches(loader, epochs=2):
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out.append([tuple(np.asarray(t) for t in batch) for batch in loader])
    return out


@pytest.mark.parametrize("sampled", [False, True])
def test_process_workers_give_the_thread_workers_batches(sampled):
    dataset = workers.SeededDataset(11, (1, 8, 8))

    def sampler(cls):
        return cls(len(dataset), 2, 1, seed=3) if sampled else None

    kwargs = dict(batch_size=2, shuffle=True, seed=4, drop_last=False)
    threads = DataLoader(dataset, num_workers=2, sampler=sampler(DistributedIndexSampler), **kwargs)
    processes = DataLoader(dataset, num_workers=2, worker_mode="process", sampler=sampler(DistributedIndexSampler),
                           **kwargs)
    reference = JaxDataLoader(dataset, num_workers=2, sampler=sampler(JaxSampler), **kwargs)
    try:
        got = _batches(processes)
        assert processes._pool is not None  # the pool persists across epochs
        for batch in processes:
            assert all(isinstance(t, torch.Tensor) for t in batch)
        processes.shutdown()
        assert processes._pool is None
        again = _batches(processes, epochs=1)
        assert processes._pool is not None
    finally:
        processes.shutdown()
    expected, jax_batches = _batches(threads), _batches(reference)
    assert len(processes) == len(threads) == len(reference) == len(got[0])
    for epoch in range(2):
        for ours, mine, theirs in zip(got[epoch], expected[epoch], jax_batches[epoch]):
            for a, b, c in zip(ours, mine, theirs):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)
    assert [b[1].ravel().tolist() for b in got[0]] != [b[1].ravel().tolist() for b in got[1]]
    assert len(again[0]) == len(got[0])
