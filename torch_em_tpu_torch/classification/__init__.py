"""Classification training: the dataset, the loss and metric, the trainer and its logger."""

from .classification import (
    ClassificationMetric, CrossEntropyLoss, default_classification_loader, default_classification_trainer,
)
from .classification_dataset import ClassificationDataset
from .classification_logger import ClassificationLogger
from .classification_trainer import ClassificationTrainer

__all__ = [
    "ClassificationMetric", "CrossEntropyLoss", "default_classification_loader", "default_classification_trainer",
    "ClassificationDataset", "ClassificationLogger", "ClassificationTrainer",
]
