"""MeanTeacher self-training and domain adaptation.

Counterpart of ``torch_em_tpu/self_training/mean_teacher.py`` (torch-em's
``self_training/mean_teacher.py``; Tarvainen & Valpola, arXiv:1703.01780):

- a teacher predicts pseudo-labels on one view of unlabelled data, and the
  student learns them on another view;
- unsupervised epochs over ``(xu1, xu2)`` batches, or semi-supervised ones
  over the two loaders zipped, with the loss ``(supervised + unsupervised)
  / 2``;
- the teacher is a copy of the student, or with ``reinit_teacher`` (the
  default when a supervised loader is given) a fresh model from the
  student's factory seeded ``seed + 1``, whose moving average then warms up
  with the momentum ``min(1 - 1 / (iteration + 1), momentum)``;
- after each optimizer step the teacher takes the moving average of the
  student (``trainer/ema.py``: every parameter and floating buffer, as the
  JAX package's update over all variables);
- the teacher's forward runs without gradient, in eval mode and in the
  student's compute precision (both are in ``_compute_models``);
- pseudo-labels stay on the device; they are read on the host only for the
  optional ``sampler(pseudo_labels, label_filter)``, which can turn a batch
  down;
- checkpoints carry ``teacher_state``.

``MeanTeacherTrainerWithInvertibleAugmentations`` warps the student's input
and inverse-warps its prediction before the unsupervised loss; the scalar
parameters of the warp come from ``host_generator`` (a CPU generator seeded
``seed``), the noise from the trainer's ``generator``.
"""

import copy
from typing import Callable, Optional

import numpy as np
import torch

from ..trainer.default_trainer import DefaultTrainer
from ..trainer.ema import MovingAverage
from ..trainer.serialization import resolve_path
from .logger import SelfTrainingTensorboardLogger

__all__ = ["Dummy", "MeanTeacherTrainer", "MeanTeacherTrainerWithInvertibleAugmentations"]


class Dummy:
    """Placeholder for the trainer's ``loss`` and ``metric``: the self-training losses replace them."""

    init_kwargs = {}

    def __init__(self, **kwargs):
        pass

    def __call__(self, *args, **kwargs):
        raise RuntimeError("Dummy loss should never be called.")


class MeanTeacherTrainer(DefaultTrainer):
    """Trainer for MeanTeacher semi-supervised learning and domain adaptation.

    Args:
        model: The student, built by one of the port's factories.
        unsupervised_train_loader: Loader of ``(xu1, xu2)``: the teacher's and the student's view.
        unsupervised_loss: ``loss(student, xu2, pseudo_labels, label_filter, generator=...)``.
        pseudo_labeler: ``pseudo_labeler(teacher, xu1)`` -> ``(pseudo_labels, label_filter)``.
        supervised_train_loader: Loader of labelled ``(x, y)``; makes the training semi-supervised.
        unsupervised_val_loader: Loader of ``(x1, x2)`` for validation.
        supervised_val_loader: Loader of ``(x, y)`` for validation.
        supervised_loss: ``loss(student, x, y, generator=...)``, with a supervised loader.
        unsupervised_loss_and_metric: Validation on the unlabelled views.
        supervised_loss_and_metric: Validation on the labelled data.
        logger: The logger class; ``SelfTrainingTensorboardLogger`` by default, as in the JAX package.
        momentum: Weight of the teacher's own state in its moving average.
        reinit_teacher: Start the teacher from a fresh model (default: with a supervised loader).
        sampler: ``sampler(pseudo_labels, label_filter)`` on numpy arrays; False skips the batch.
        kwargs: The ``DefaultTrainer``'s arguments.
    """

    def __init__(
        self,
        model=None,
        unsupervised_train_loader=None,
        unsupervised_loss=None,
        pseudo_labeler=None,
        supervised_train_loader=None,
        unsupervised_val_loader=None,
        supervised_val_loader=None,
        supervised_loss: Optional[Callable] = None,
        unsupervised_loss_and_metric: Optional[Callable] = None,
        supervised_loss_and_metric: Optional[Callable] = None,
        logger=SelfTrainingTensorboardLogger,
        momentum: float = 0.999,
        reinit_teacher: Optional[bool] = None,
        sampler: Optional[Callable] = None,
        **kwargs,
    ):
        self._semisupervised = supervised_train_loader is not None
        if self._semisupervised:
            if supervised_loss is None:
                raise ValueError("A supervised_train_loader needs a supervised_loss.")
            # the shorter loader sets the epoch's length
            train_loader = supervised_train_loader if len(supervised_train_loader) < len(unsupervised_train_loader) \
                else unsupervised_train_loader
        else:
            train_loader = unsupervised_train_loader
        if supervised_val_loader is None and unsupervised_val_loader is None:
            raise ValueError("The trainer needs a supervised_val_loader or an unsupervised_val_loader.")
        if supervised_loss_and_metric is None and unsupervised_loss_and_metric is None:
            raise ValueError("The trainer needs a supervised or an unsupervised loss_and_metric.")
        val_loader = supervised_val_loader if unsupervised_val_loader is None else unsupervised_val_loader
        for key in ("train_loader", "val_loader", "metric", "loss"):
            kwargs.pop(key, None)
        super().__init__(model=model, train_loader=train_loader, val_loader=val_loader, loss=Dummy(),
                         metric=Dummy(), logger=logger, **kwargs)
        self.unsupervised_train_loader = unsupervised_train_loader
        self.supervised_train_loader = supervised_train_loader
        self.unsupervised_val_loader = unsupervised_val_loader
        self.supervised_val_loader = supervised_val_loader
        self.unsupervised_loss = unsupervised_loss
        self.supervised_loss = supervised_loss
        self.unsupervised_loss_and_metric = unsupervised_loss_and_metric
        self.supervised_loss_and_metric = supervised_loss_and_metric
        self.pseudo_labeler = pseudo_labeler
        self.momentum = momentum
        self.reinit_teacher = self._semisupervised if reinit_teacher is None else reinit_teacher
        self.sampler = sampler
        self.teacher: Optional[torch.nn.Module] = None
        self._ema: Optional[MovingAverage] = None
        # the scalar draws of the invertible augmentations, on the host
        self.host_generator = torch.Generator().manual_seed(self.seed)

        # the loaders, loss and metric that the base class holds follow from these
        for key in ("train_loader", "val_loader", "loss", "metric"):
            del self._explicit_init_kwargs[key]
        self._explicit_init_kwargs.update(
            unsupervised_train_loader=unsupervised_train_loader, unsupervised_loss=unsupervised_loss,
            pseudo_labeler=pseudo_labeler, supervised_train_loader=supervised_train_loader,
            unsupervised_val_loader=unsupervised_val_loader, supervised_val_loader=supervised_val_loader,
            supervised_loss=supervised_loss, unsupervised_loss_and_metric=unsupervised_loss_and_metric,
            supervised_loss_and_metric=supervised_loss_and_metric, momentum=momentum,
            reinit_teacher=reinit_teacher, sampler=sampler)

    # ------------------------------------------------------------ teacher
    def _compute_models(self):
        return [self.model] if self.teacher is None or self.teacher is self.model else [self.model, self.teacher]

    def _init_teacher(self, reinit: bool = False):
        """A frozen copy of the student, or (``reinit``) a fresh model from its factory seeded seed + 1."""
        if reinit:
            factory = getattr(self.model, "factory", None)
            if not isinstance(factory, str):
                raise ValueError("reinit_teacher needs a model built by one of the port's factories")
            teacher = resolve_path(factory)(**{**self.model.init_kwargs, "seed": self.seed + 1,
                                               "device": str(self.device)})
        else:
            teacher = copy.deepcopy(self.model)
        self.teacher = teacher.to(self.device).requires_grad_(False).eval()
        self._ema = None

    def _initialize(self, iterations, load_from_checkpoint, epochs=None):
        best_metric = super()._initialize(iterations, load_from_checkpoint, epochs)
        if self.teacher is None:
            self._init_teacher(self.reinit_teacher)
        return best_metric

    def _current_momentum(self) -> float:
        if self.reinit_teacher:  # fast teacher updates early on close the gap of a fresh teacher
            return min(1 - 1 / (self._iteration + 1), self.momentum)
        return self.momentum

    def ema_update(self):
        """teacher <- teacher * m + student * (1 - m), with m the current momentum rounded to float32
        as the JAX step takes it, on the device."""
        if self._ema is None:
            self._ema = MovingAverage(self.teacher, self.model)
        self._ema.update(float(np.float32(self._current_momentum())))

    def _teacher_forward(self, x):
        with torch.no_grad(), self._compute_precision():
            return self.teacher(x)

    def _student(self, x):
        with self._compute_precision():
            return self.model(x)

    def _pseudo_labels(self, x):
        kwargs = {"generator": self.generator} if getattr(self.pseudo_labeler, "needs_rng", False) else {}
        return self.pseudo_labeler(self._teacher_forward, x, **kwargs)

    # -------------------------------------------------------------- steps
    def _unsupervised_apply(self) -> Callable:
        """The student's forward as the unsupervised loss sees it."""
        return self._student

    def _optimizer_step(self, loss):
        loss.backward()
        self.optimizer.clip_gradients(self.model.parameters())
        self.torch_optimizer.step()
        self.ema_update()

    def _unsupervised_step(self, xu1, xu2):
        pseudo_labels, label_filter = self._pseudo_labels(xu1)
        if self.sampler is not None and not self.sampler(
                pseudo_labels.cpu().numpy(), None if label_filter is None else label_filter.cpu().numpy()):
            return None
        self.torch_optimizer.zero_grad(set_to_none=True)
        loss = self.unsupervised_loss(self._unsupervised_apply(), xu2, pseudo_labels, label_filter,
                                      generator=self.generator)
        self._optimizer_step(loss)
        return loss.detach(), pseudo_labels, label_filter

    def _semisupervised_step(self, xs, ys, xu1, xu2):
        pseudo_labels, label_filter = self._pseudo_labels(xu1)
        self.torch_optimizer.zero_grad(set_to_none=True)
        sup = self.supervised_loss(self._student, xs, ys, generator=self.generator)
        unsup = self.unsupervised_loss(self._student, xu2, pseudo_labels, label_filter, generator=self.generator)
        loss = (sup + unsup) / 2
        self._optimizer_step(loss)
        return loss.detach(), sup.detach(), unsup.detach(), pseudo_labels, label_filter

    def _train_step(self, *batch):
        """One step on a batch on the device; None where the sampler turned the batch down."""
        return self._semisupervised_step(*batch) if self._semisupervised else self._unsupervised_step(*batch)

    def _train_batches(self):
        if self._semisupervised:
            for (xs, ys), (xu1, xu2) in zip(self.supervised_train_loader, self.unsupervised_train_loader):
                yield tuple(self._to_device(v) for v in (xs, ys, xu1, xu2))
        else:
            for xu1, xu2 in self.unsupervised_train_loader:
                yield self._to_device(xu1), self._to_device(xu2)

    def _log_train_step(self, batch, out, lr, buffer):
        """Buffer the step's losses, and every ``log_image_interval`` steps its images, as
        ``DefaultTrainer`` does: the losses are read when the buffer is flushed."""
        step, logger = self._iteration, self.logger
        images = step % self.log_image_interval == 0
        if not images:  # the buffer holds no batch on the device
            batch, out = (None,) * len(batch), out[:-2] + (None, None)
        ct = None if self._semisupervised else self.pseudo_labeler.confidence_threshold

        def write():
            if self._semisupervised:
                (xs, ys, xu1, xu2), (loss, sup, unsup, pseudo_labels, label_filter) = batch, out
                logger.log_train_supervised(step, float(sup), xs, ys, None)
                logger.log_train_unsupervised(step, float(unsup), xu1, xu2, None, pseudo_labels, label_filter)
                logger.log_combined_loss(step, float(loss))
            else:
                (xu1, xu2), (loss, pseudo_labels, label_filter) = batch, out
                logger.log_train_unsupervised(step, float(loss), xu1, xu2, None, pseudo_labels, label_filter)
            logger.log_lr(step, lr)
            if ct is not None:
                logger.log_ct(step, ct)

        self._buffer_log(buffer, write, images)

    # --------------------------------------------------------- validation
    def _capturing_student(self):
        """The student's forward, keeping its outputs: the logged prediction is the loss's own."""
        outputs = []

        def student(x):
            outputs.append(self._student(x))
            return outputs[-1]

        return student, outputs

    def _supervised_val_step(self, x, y):
        student, outputs = self._capturing_student()
        loss, metric = self.supervised_loss_and_metric(student, x, y)
        return loss, metric, (x, y, outputs[-1])

    def _unsupervised_val_step(self, x1, x2):
        pseudo_labels, label_filter = self._pseudo_labels(x1)
        student, outputs = self._capturing_student()
        loss, metric = self.unsupervised_loss_and_metric(student, x2, pseudo_labels, label_filter,
                                                         generator=self.generator)
        return loss, metric, (x1, x2, outputs[-1], pseudo_labels, label_filter)

    def _val_batches(self, loader):
        for batch in loader:
            yield tuple(self._to_device(v) for v in batch)

    def _validate_over(self, loader, step):
        """Mean metric, mean loss and the last batch's logged tensors of ``step`` over ``loader``."""
        losses, metrics, last = [], [], None
        for batch in self._val_batches(loader):
            loss, metric, last = step(*batch)
            losses.append(float(loss))
            metrics.append(float(metric))
        return float(np.mean(metrics)), float(np.mean(losses)), last

    @torch.no_grad()
    def _validate(self):
        self.model.eval()
        supervised_metric = unsupervised_metric = None
        if self.supervised_val_loader is not None:
            supervised_metric, loss, last = self._validate_over(self.supervised_val_loader,
                                                                self._supervised_val_step)
            if self.logger is not None and last is not None:
                self.logger.log_validation_supervised(self._iteration, supervised_metric, loss, *last)
        if self.unsupervised_val_loader is not None:
            unsupervised_metric, loss, last = self._validate_over(self.unsupervised_val_loader,
                                                                  self._unsupervised_val_step)
            if self.logger is not None and last is not None:
                self.logger.log_validation_unsupervised(self._iteration, unsupervised_metric, loss, *last)
            self.pseudo_labeler.step(unsupervised_metric, self._epoch)
        if unsupervised_metric is None:
            return supervised_metric
        if supervised_metric is None:
            return unsupervised_metric
        return (supervised_metric + unsupervised_metric) / 2

    # -------------------------------------------------------- checkpoints
    def save_checkpoint(self, name, current_metric, best_metric, train_time=0.0, **extra_save_dict):
        super().save_checkpoint(name, current_metric, best_metric, train_time=train_time,
                                teacher_state=self.teacher.state_dict(), **extra_save_dict)

    def load_checkpoint(self, checkpoint="best"):
        save_dict = super().load_checkpoint(checkpoint)
        if "teacher_state" in save_dict:
            if self.teacher is None:
                self._init_teacher()
            self.teacher.load_state_dict(save_dict["teacher_state"])
        return save_dict


class MeanTeacherTrainerWithInvertibleAugmentations(MeanTeacherTrainer):
    """MeanTeacher whose unsupervised step warps the student's input and inverse-warps its
    prediction (``augmenter``: e.g. ``MeanTeacherAugmenters``) before the loss."""

    def __init__(self, augmenter=None, **kwargs):
        super().__init__(**kwargs)
        self.augmenter = augmenter
        self._explicit_init_kwargs["augmenter"] = augmenter

    def _unsupervised_apply(self):
        if self.augmenter is None:
            return self._student

        def student(x):
            warped, params = self.augmenter.forward(x, self.host_generator, self.generator)
            return self.augmenter.inverse(self._student(warped), params)

        return student
