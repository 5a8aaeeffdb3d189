"""FixMatch self-training.

Counterpart of ``torch_em_tpu/self_training/fix_match.py`` (torch-em's
``self_training/fix_match.py``; FixMatch, arXiv:2001.07685): the same
network predicts the pseudo-labels on the weak view (xu1) and learns them on
the strong view (xu2). With ``source_distribution``, the pseudo-labels are
scaled so that their foreground share matches it (distribution alignment).

The JAX package's teacher is a second copy of the network that a moving
average of momentum 0 sets to the student after every step, only because
its steps donate their buffers. Here the teacher is the student itself: the
numbers are the same, and the model is held once. Its pseudo-labelling
forward runs in eval mode, as the JAX package applies the teacher with
``train=False``.
"""

from typing import List, Optional

import torch

from .mean_teacher import MeanTeacherTrainer

__all__ = ["FixMatchTrainer", "FixMatchTrainerWithInvertibleAugmentations"]


class FixMatchTrainer(MeanTeacherTrainer):
    """FixMatch: the student is its own teacher; optional distribution alignment."""

    def __init__(self, source_distribution: Optional[List[float]] = None, momentum: float = 0.999, **kwargs):
        super().__init__(momentum=momentum, **kwargs)
        self.source_distribution = source_distribution
        self._explicit_init_kwargs["source_distribution"] = source_distribution

    def _init_teacher(self, reinit: bool = False):
        self.teacher = self.model

    def ema_update(self):
        """Nothing to average: the teacher is the student."""

    def _teacher_forward(self, x):
        training = self.model.training
        self.model.eval()
        try:
            return super()._teacher_forward(x)
        finally:
            self.model.train(training)

    def _distribution_alignment(self, pseudo_labels: torch.Tensor, label_threshold: float = 0.5) -> torch.Tensor:
        """Scale the pseudo-labels below and above ``label_threshold`` by the ratios of the source's
        background and foreground shares to theirs, clipped to [0, 1]."""
        if self.source_distribution is None:
            return pseudo_labels
        source = torch.tensor(self.source_distribution, dtype=torch.float32, device=pseudo_labels.device)
        pos = (pseudo_labels >= label_threshold).float().mean()
        ratio = source / torch.stack([1.0 - pos, pos]).clamp_min(1e-6)
        aligned = torch.where(pseudo_labels < label_threshold, pseudo_labels * ratio[0], pseudo_labels * ratio[1])
        return aligned.clamp(0, 1)

    def _pseudo_labels(self, x):
        pseudo_labels, label_filter = super()._pseudo_labels(x)
        return self._distribution_alignment(pseudo_labels), label_filter


class FixMatchTrainerWithInvertibleAugmentations(FixMatchTrainer):
    """FixMatch holding an ``augmenter`` (e.g. ``FixMatchAugmenters``). As in the JAX package, the
    augmenter is stored and recorded in checkpoints, and the steps are ``FixMatchTrainer``'s: it
    warps nothing (``ROADMAP.md`` records the gap)."""

    def __init__(self, augmenter=None, **kwargs):
        super().__init__(**kwargs)
        self.augmenter = augmenter
        self._explicit_init_kwargs["augmenter"] = augmenter
