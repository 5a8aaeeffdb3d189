"""Training loop, checkpointing, optimizers and the logger interface."""

from .default_trainer import DefaultTrainer
from .logger_base import TorchEmLogger
from .optimizers import OptimizerSpec, ReduceLROnPlateau

__all__ = ["DefaultTrainer", "TorchEmLogger", "OptimizerSpec", "ReduceLROnPlateau"]
