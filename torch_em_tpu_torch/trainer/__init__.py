"""Training loop, checkpointing, optimizers, the SPOCO and bf16 trainers and the loggers."""

from .default_trainer import DefaultTrainer
from .flashoptim_trainer import FlashOptimTrainer
from .logger_base import TorchEmLogger
from .optimizers import OptimizerSpec, ReduceLROnPlateau
from .spoco_trainer import SPOCOTrainer
from .tensorboard_logger import TensorboardLogger
from .wandb_logger import WandbLogger

__all__ = ["DefaultTrainer", "FlashOptimTrainer", "TorchEmLogger", "OptimizerSpec", "ReduceLROnPlateau", "SPOCOTrainer",
           "TensorboardLogger", "WandbLogger"]
