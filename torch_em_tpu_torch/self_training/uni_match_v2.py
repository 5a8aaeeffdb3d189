"""UniMatch v2 self-training.

Counterpart of ``torch_em_tpu/self_training/uni_match_v2.py`` (torch-em's
``self_training/uni_match_v2.py``; UniMatch v2, arXiv:2410.10777): the
teacher labels a weak view of each unlabelled batch, and its pseudo-labels
and filter are inverse-warped to the batch's own frame; the student sees two
strong views as one batch of twice the size, each half is inverse-warped,
and the loss is averaged over the two. An ``UniMatchv2Augmenters`` bundle
makes the three views on the batch's device: the scalar parameters from the
trainer's ``host_generator``, the noise from its ``generator``.

``complementary_dropout`` is stored and used nowhere, as in the JAX package
(``ROADMAP.md`` records the gap). In semi-supervised mode the steps are
``MeanTeacherTrainer``'s, as the JAX package builds them.
"""

import torch

from ..loss import DiceLoss
from ..models.base import get_activation
from .mean_teacher import MeanTeacherTrainerWithInvertibleAugmentations

__all__ = ["UniMatchv2Trainer", "DefaultUnimatchLoss", "DefaultUnimatchLossAndMetric"]


class DefaultUnimatchLoss:
    """``loss`` averaged over the stacked views ``predictions[v]``, each masked by the filter."""

    def __init__(self, loss=None, activation=None):
        self.loss = DiceLoss() if loss is None else loss
        self.activation = get_activation(activation)
        self.init_kwargs = {"loss": self.loss, "activation": activation}

    def _view(self, pred):
        return pred if self.activation is None else self.activation(pred)

    def __call__(self, predictions, pseudo_labels, label_filter=None, pred_dim: int = 2, generator=None):
        total = 0.0
        for v in range(predictions.shape[0]):
            pred = self._view(predictions[v])
            if label_filter is None:
                total = total + self.loss(pred, pseudo_labels)
            else:
                total = total + self.loss(pred * label_filter, pseudo_labels * label_filter)
        return total / predictions.shape[0]


class DefaultUnimatchLossAndMetric(DefaultUnimatchLoss):
    """The loss over the views, and the metric on the first view."""

    def __init__(self, loss=None, metric=None, activation=None):
        super().__init__(loss, activation)
        self.metric = DiceLoss() if metric is None else metric
        self.init_kwargs = {"loss": self.loss, "metric": self.metric, "activation": activation}

    def __call__(self, predictions, pseudo_labels, label_filter=None, pred_dim: int = 2, generator=None):
        loss = super().__call__(predictions, pseudo_labels, label_filter, pred_dim)
        return loss, self.metric(self._view(predictions[0]), pseudo_labels)


class UniMatchv2Trainer(MeanTeacherTrainerWithInvertibleAugmentations):
    """Trainer for UniMatch v2; the unlabelled loader yields one raw view per sample (of a
    tuple, the first)."""

    def __init__(self, augmenter=None, complementary_dropout: bool = False, **kwargs):
        if augmenter is None:
            raise ValueError("UniMatchv2Trainer needs a UniMatchv2Augmenters instance.")
        super().__init__(augmenter=augmenter, **kwargs)
        self.complementary_dropout = complementary_dropout
        self._explicit_init_kwargs["complementary_dropout"] = complementary_dropout

    def _views(self, x_u):
        """Inverse-warped pseudo-labels and filter of the weak view, and the two strong views as
        one batch with their parameters."""
        aug, draws = self.augmenter, (self.host_generator, self.generator)
        x_w, w_params = aug.weak.forward(x_u, *draws)
        pseudo_labels, label_filter = self._pseudo_labels(x_w)
        pseudo_labels = aug.weak.inverse(pseudo_labels, w_params)
        if label_filter is not None:
            label_filter = aug.weak.inverse(label_filter, w_params)
        x_s1, s1_params = aug.strong1.forward(x_u, *draws)
        x_s2, s2_params = aug.strong2.forward(x_u, *draws)
        return pseudo_labels, label_filter, torch.cat([x_s1, x_s2]), s1_params, s2_params

    def _strong_predictions(self, both, s1_params, s2_params):
        """The student on both strong views, each half inverse-warped, stacked: (2, B, C, ...)."""
        preds = self._student(both)
        n = both.shape[0] // 2
        return torch.stack([self.augmenter.strong1.inverse(preds[:n], s1_params),
                            self.augmenter.strong2.inverse(preds[n:], s2_params)])

    def _unimatch_step(self, x_u):
        pseudo_labels, label_filter, both, s1_params, s2_params = self._views(x_u)
        self.torch_optimizer.zero_grad(set_to_none=True)
        loss = self.unsupervised_loss(self._strong_predictions(both, s1_params, s2_params), pseudo_labels,
                                      label_filter, pred_dim=2, generator=self.generator)
        self._optimizer_step(loss)
        return (loss.detach(),)

    def _train_step(self, *batch):
        return super()._train_step(*batch) if self._semisupervised else self._unimatch_step(*batch)

    def _first_views(self, loader):
        for x_u in loader:
            yield (self._to_device(x_u[0] if isinstance(x_u, (tuple, list)) else x_u),)

    def _train_batches(self):
        return super()._train_batches() if self._semisupervised else self._first_views(self.unsupervised_train_loader)

    def _log_train_step(self, batch, out, lr, buffer):
        if self._semisupervised:
            return super()._log_train_step(batch, out, lr, buffer)
        (x_u,), (loss,) = batch, out
        step, images = self._iteration, self._iteration % self.log_image_interval == 0
        x_u = x_u if images else None

        def write():
            self.logger.log_train_unsupervised(step, float(loss), x_u, x_u, None)
            self.logger.log_lr(step, lr)

        self._buffer_log(buffer, write, images)

    def _val_batches(self, loader):
        if loader is self.unsupervised_val_loader:
            return self._first_views(loader)
        return super()._val_batches(loader)

    def _unsupervised_val_step(self, x_u):
        pseudo_labels, label_filter, both, s1_params, s2_params = self._views(x_u)
        preds = self._strong_predictions(both, s1_params, s2_params)
        loss, metric = self.unsupervised_loss_and_metric(preds, pseudo_labels, label_filter, pred_dim=2,
                                                         generator=self.generator)
        return loss, metric, (x_u, x_u, preds[0], pseudo_labels, label_filter)
