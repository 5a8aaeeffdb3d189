"""Pseudo-labelers for self-training.

Counterpart of ``torch_em_tpu/self_training/pseudo_labeling.py`` (torch-em's
``self_training/pseudo_labeling.py``). A pseudo-labeler is called as
``pseudo_labeler(teacher, input_)``, where ``teacher`` is the teacher's
forward, and returns ``(pseudo_labels, label_filter)``; the filter is None
without a confidence threshold. Labels and masks stay on the teacher
output's device. ``ScheduledPseudoLabeler`` lowers its threshold on the
host, from ``step(metric, epoch)`` after each validation.
"""

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..models.base import get_activation

__all__ = ["DefaultPseudoLabeler", "ProbabilisticPseudoLabeler", "ScheduledPseudoLabeler"]


def _confidence_mask(values: torch.Tensor, ct: float, both_sides: bool) -> torch.Tensor:
    """1 where ``values`` >= ct (or, from both sides, <= 1 - ct, computed in float32 as the JAX
    trainers' traced threshold), else 0."""
    mask = values >= ct
    if both_sides:
        mask = mask | (values <= float(np.float32(1.0) - np.float32(ct)))
    return mask.float()


class DefaultPseudoLabeler:
    """Pseudo-labels are the activated teacher predictions, masked by a confidence threshold.

    Args:
        activation: Applied to the teacher's output (a callable or a name such as "Sigmoid").
        confidence_threshold: Keep pixels at or above it (and, from both sides, at or below
            1 minus it); None keeps every pixel and returns no filter.
        threshold_from_both_sides: Whether low values count as confident too.
        mask_channel: Take the mask from this channel alone and broadcast it to every channel.
    """

    def __init__(self, activation: Optional[Union[str, Callable]] = None,
                 confidence_threshold: Optional[float] = None, threshold_from_both_sides: bool = True,
                 mask_channel: Optional[int] = None):
        self.activation = get_activation(activation)
        self.confidence_threshold = confidence_threshold
        self.threshold_from_both_sides = threshold_from_both_sides
        self.mask_channel = mask_channel
        self.init_kwargs = {
            "activation": activation, "confidence_threshold": confidence_threshold,
            "threshold_from_both_sides": threshold_from_both_sides, "mask_channel": mask_channel,
        }

    def __call__(self, teacher: Callable, input_: torch.Tensor, confidence_threshold: Optional[float] = None):
        pseudo_labels = teacher(input_)
        if self.activation is not None:
            pseudo_labels = self.activation(pseudo_labels)
        ct = self.confidence_threshold if confidence_threshold is None else confidence_threshold
        if ct is None:
            return pseudo_labels, None
        mask_input = pseudo_labels if self.mask_channel is None \
            else pseudo_labels[:, self.mask_channel:self.mask_channel + 1]
        label_mask = _confidence_mask(mask_input, ct, self.threshold_from_both_sides)
        if self.mask_channel is not None:
            label_mask = label_mask.expand_as(pseudo_labels)
        return pseudo_labels, label_mask

    def step(self, metric, epoch):
        pass


class ProbabilisticPseudoLabeler:
    """Pseudo-labels from ``prior_samples`` prior samples of a Probabilistic U-Net: their mean
    gives the labels; the mean (or, with ``consensus_masking``, the product) of their confidence
    masks gives the filter.

    The teacher is called as ``teacher_sample(input_, generator)`` and draws one sample.
    """

    needs_rng = True

    def __init__(self, activation: Optional[Union[str, Callable]] = None,
                 confidence_threshold: Optional[float] = None, threshold_from_both_sides: bool = True,
                 prior_samples: int = 16, consensus_masking: bool = False):
        self.activation = get_activation(activation)
        self.confidence_threshold = confidence_threshold
        self.threshold_from_both_sides = threshold_from_both_sides
        self.prior_samples = prior_samples
        self.consensus_masking = consensus_masking
        self.init_kwargs = {
            "activation": activation, "confidence_threshold": confidence_threshold,
            "threshold_from_both_sides": threshold_from_both_sides,
            "prior_samples": prior_samples, "consensus_masking": consensus_masking,
        }

    def __call__(self, teacher_sample: Callable, input_: torch.Tensor, confidence_threshold: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        samples = torch.stack([teacher_sample(input_, generator) for _ in range(self.prior_samples)])
        if self.activation is not None:
            samples = self.activation(samples)
        pseudo_labels = samples.mean(dim=0)
        ct = self.confidence_threshold if confidence_threshold is None else confidence_threshold
        if ct is None:
            return pseudo_labels, None
        masks = _confidence_mask(samples, ct, self.threshold_from_both_sides)
        # complete agreement, or a weighted consensus
        label_mask = masks.prod(dim=0) if self.consensus_masking else masks.mean(dim=0)
        return pseudo_labels, label_mask

    def step(self, metric, epoch):
        pass


class ScheduledPseudoLabeler(DefaultPseudoLabeler):
    """``DefaultPseudoLabeler`` whose threshold falls by ``factor`` (down to ``min_ct``) when the
    validation metric has not improved for more than ``patience`` validations."""

    def __init__(self, activation=None, confidence_threshold: Optional[float] = None,
                 threshold_from_both_sides: bool = True, mask_channel: Optional[int] = None,
                 mode: str = "min", factor: float = 0.05, patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", min_ct: float = 0.5, verbose: bool = False):
        super().__init__(activation, confidence_threshold, threshold_from_both_sides, mask_channel)
        if mode not in ("min", "max") or threshold_mode not in ("rel", "abs"):
            raise ValueError(f"Invalid mode {mode!r} or threshold_mode {threshold_mode!r}")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.min_ct = min_ct
        self.verbose = verbose
        self.best = None
        self.num_bad_epochs = 0
        self.init_kwargs.update({
            "mode": mode, "factor": factor, "patience": patience, "threshold": threshold,
            "threshold_mode": threshold_mode, "min_ct": min_ct, "verbose": verbose,
        })

    def _is_better(self, current):
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            if self.mode == "min":
                return current < self.best * (1.0 - self.threshold)
            return current > self.best * (1.0 + self.threshold)
        if self.mode == "min":
            return current < self.best - self.threshold
        return current > self.best + self.threshold

    def step(self, metric, epoch):
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            if self.confidence_threshold is not None:
                new_ct = max(self.confidence_threshold - self.factor, self.min_ct)
                if self.verbose and new_ct < self.confidence_threshold:
                    print(f"ScheduledPseudoLabeler: reducing confidence threshold to {new_ct}")
                self.confidence_threshold = new_ct
