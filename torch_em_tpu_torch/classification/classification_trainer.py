"""The classification trainer, counterpart of ``torch_em_tpu/classification/classification_trainer.py``."""

import warnings

import numpy as np
import torch

from ..trainer.default_trainer import DefaultTrainer

__all__ = ["ClassificationTrainer"]


class ClassificationTrainer(DefaultTrainer):
    """``DefaultTrainer`` whose validation scores the argmax predictions of the whole
    validation set at once with its (host) metric, and warns when they are NaN."""

    def _validate(self):
        self.model.eval()
        losses, y_true, y_pred, last = [], [], [], None
        for x, y in self.val_loader:
            x, y = self._to_device(x), self._to_device(y)
            loss, _, pred = self._val_step(x, y)
            losses.append(loss)
            y_true.append(y.cpu().numpy())
            y_pred.append(pred.argmax(dim=1).cpu().numpy())
            last = (x, y, pred)
        if bool(torch.isnan(last[2]).any()):
            warnings.warn("Predictions are NaN")
        loss_val = float(np.mean([float(v) for v in losses]))
        y_true, y_pred = np.concatenate(y_true), np.concatenate(y_pred)
        metric_val = self.metric(y_true, y_pred)
        if self.logger is not None:
            self.logger.log_validation(self._iteration, metric_val, loss_val, *last, y_true=y_true, y_pred=y_pred)
        return metric_val
