"""Map-style dataset base, counterpart of ``torch_em_tpu/data/base.py``.

A dataset is a ``torch.utils.data.Dataset`` whose ``__getitem__`` returns
numpy samples (C, *spatial); the loader collates them into tensors.
"""

import torch

__all__ = ["Dataset"]


class Dataset(torch.utils.data.Dataset):
    """Map-style dataset: ``__getitem__(i) -> sample`` plus ``__len__``."""

    def __getitem__(self, index):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def __repr__(self):
        try:
            return f"{type(self).__name__}(len={len(self)})"
        except NotImplementedError:
            return type(self).__name__
