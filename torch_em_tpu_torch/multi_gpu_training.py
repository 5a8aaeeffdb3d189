"""The reference's ``torch_em.multi_gpu_training``: data-parallel training with one process
per device, implemented in :mod:`torch_em_tpu_torch.parallel`."""

from .parallel.data_parallel import DataParallelTrainer, train_multi_device, train_multi_gpu

__all__ = ["train_multi_gpu", "train_multi_device", "DataParallelTrainer"]
