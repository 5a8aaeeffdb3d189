"""Dataset concatenation: the port's own copy of ``torch_em_tpu/data/concat_dataset.py``
(after torch-em's ``data/concat_dataset.py``), with cumulative-offset index routing."""

from typing import Optional, Sequence

import numpy as np

from .base import Dataset


class ConcatDataset(Dataset):
    """Concatenate multiple datasets with cumulative-offset index routing."""

    def __init__(self, *args: Dataset, datasets: Optional[Sequence[Dataset]] = None):
        """``ConcatDataset(ds1, ds2, ...)``; a trainer checkpoint rebuilds it from its
        ``init_kwargs`` as ``ConcatDataset(datasets=[...])``."""
        if datasets is not None and args:
            raise ValueError("pass the datasets either as arguments or as datasets=, not both")
        datasets = tuple(args) if datasets is None else tuple(datasets)
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.datasets = datasets
        self.ndim = datasets[0].ndim
        self.ds_lens = [len(dataset) for dataset in self.datasets]
        self._len = sum(self.ds_lens)
        self.ds_offsets = np.cumsum(self.ds_lens)
        self.init_kwargs = {"datasets": datasets}

    def __len__(self):
        return self._len

    def __getitem__(self, idx):
        ds_idx = int(np.searchsorted(self.ds_offsets, idx, side="right"))
        ds = self.datasets[ds_idx]
        offset = self.ds_offsets[ds_idx - 1] if ds_idx > 0 else 0
        idx_in_ds = idx - offset
        assert 0 <= idx_in_ds < len(ds), f"Failed with: {idx_in_ds}, {len(ds)}"
        return ds[idx_in_ds]
