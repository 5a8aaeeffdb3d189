"""Item-wrapping dataset: the port's own copy of ``torch_em_tpu/data/dataset_wrapper.py``
(after torch-em's ``data/dataset_wrapper.py``)."""

from typing import Callable

from .base import Dataset


class DatasetWrapper(Dataset):
    """Wrap any dataset with a ``wrap_item`` hook applied per item."""

    def __init__(self, dataset: Dataset, wrap_item: Callable):
        self.dataset = dataset
        self.wrap_item = wrap_item
        self.ndim = getattr(dataset, "ndim", None)
        self.init_kwargs = {"dataset": dataset, "wrap_item": wrap_item}

    def __getitem__(self, item):
        return self.wrap_item(self.dataset[item])

    def __len__(self):
        return len(self.dataset)
