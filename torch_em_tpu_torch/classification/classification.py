"""Classification factories, counterpart of ``torch_em_tpu/classification/classification.py``.

The card's machine has no sklearn: ``ClassificationMetric`` computes the
``sklearn.metrics`` scores of two label vectors in numpy (``scores.py``);
another metric name imports ``sklearn.metrics`` when the metric is built.
"""

from functools import partial
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.vit import at_least_f32
from ..segmentation import default_segmentation_trainer, get_data_loader
from ..transforms.augmentation import get_augmentations
from ..transforms.raw import standardize
from .classification_dataset import ClassificationDataset
from .classification_logger import ClassificationLogger
from .classification_trainer import ClassificationTrainer
from .scores import SCORES, accuracy_score

__all__ = ["ClassificationMetric", "CrossEntropyLoss", "accuracy_score", "default_classification_loader",
           "default_classification_trainer"]


class CrossEntropyLoss:
    """The mean cross entropy of logits (N, C) against integer targets (N,), in float32 or wider."""

    def __init__(self):
        self.init_kwargs = {}

    def __call__(self, pred, target):
        log_probs = torch.log_softmax(at_least_f32(pred), dim=-1)
        return -log_probs.gather(-1, target.long()[:, None]).mean()


class ClassificationMetric:
    """1 - ``metric_name`` (lower is better) of the argmax predictions against the labels, on
    the host: the scores of ``scores.SCORES`` (sklearn's of two label vectors, with their keyword
    arguments) in numpy, any other name from ``sklearn.metrics``."""

    host_metric = True

    def __init__(self, metric_name: str = "accuracy_score", **metric_kwargs):
        if metric_name in SCORES:
            self.metric = SCORES[metric_name]
        else:
            try:
                import sklearn.metrics as metrics
            except ImportError as e:
                raise ImportError(f"the classification metric {metric_name} needs scikit-learn (sklearn), which is "
                                  "not installed") from e

            if not hasattr(metrics, metric_name):
                raise ValueError(f"Invalid metric_name {metric_name}.")
            self.metric = getattr(metrics, metric_name)
        self.metric_name, self.metric_kwargs = metric_name, metric_kwargs
        self.init_kwargs = {"metric_name": metric_name, **metric_kwargs}

    def __call__(self, y_true, y_pred) -> float:
        return 1.0 - self.metric(np.asarray(y_true), np.asarray(y_pred), **self.metric_kwargs)


def default_classification_loader(data: Sequence, target: Sequence, batch_size: int, normalization=None,
                                  augmentation=None, image_shape: Optional[Tuple[int, ...]] = None, **loader_kwargs):
    """A loader of (image, class) batches: images (C, *spatial) of 2 or 3 spatial axes,
    standardized per image and augmented with ``get_augmentations(ndim)`` unless told
    otherwise."""
    ndim = data[0].ndim - 1
    if ndim not in (2, 3):
        raise ValueError(f"Expect input data of dimensionality 2 or 3, got {ndim}")
    if normalization is None:
        normalization = partial(standardize, axis=(1, 2) if ndim == 2 else (1, 2, 3))
    if augmentation is None:
        augmentation = get_augmentations(ndim=ndim)
    dataset = ClassificationDataset(data, target, normalization, augmentation, image_shape)
    return get_data_loader(dataset, batch_size, **loader_kwargs)


def default_classification_trainer(name: str, model, train_loader, val_loader, loss=None, metric=None,
                                   logger=ClassificationLogger, trainer_class=ClassificationTrainer, **kwargs):
    """A ``default_segmentation_trainer`` for classification: cross entropy, the accuracy
    error as the metric (lower is better), the ``ClassificationLogger`` and the
    ``ClassificationTrainer``."""
    return default_segmentation_trainer(
        name, model, train_loader, val_loader, loss=CrossEntropyLoss() if loss is None else loss,
        metric=ClassificationMetric() if metric is None else metric, logger=logger, trainer_class=trainer_class,
        **kwargs)
