"""Multi-device training and inference: one process per device, joined by ``torch.distributed``."""

from .checkpoint import restore_sharded_checkpoint, save_sharded_checkpoint
from .data_parallel import DataParallelTrainer, train_multi_device, train_multi_gpu
from .halo import (halo_sharded_predict, halo_sharded_predict_large, receptive_field_halo,
                   spatial_sharded_train_step, total_downscale)
from .mesh import get_mesh, init_process_group, replicate, shard_batch
