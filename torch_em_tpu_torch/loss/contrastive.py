"""Discriminative (contrastive) segmentation loss.

Counterpart of ``torch_em_tpu/loss/contrastive.py`` (torch-em's
``loss/contrastive.py``, De Brabandere et al., arXiv:1708.02551): variance
(pull), distance (push) and regularizer terms over instance means, with a
fixed ``max_instances`` slots per sample (see ``contrastive_impl``). The
target must be labeled consecutively from 0, as torch-em's expand
implementation requires.
"""

from typing import Optional

import numpy as np
import torch

from . import contrastive_impl as impl

__all__ = ["ContrastiveLoss", "check_consecutive"]


def check_consecutive(labels) -> bool:
    """Check that labels are consecutive and start at zero."""
    labels = np.asarray(labels)
    diff = labels[1:] - labels[:-1]
    return bool((labels[0] == 0) and (diff == 1).all())


class ContrastiveLoss:
    """Discriminative loss with hinged pull and push terms.

    Args:
        delta_var: Hinge distance of the variance (pull) term.
        delta_dist: Hinge distance of the distance (push) term.
        norm: Only 'fro' (L2) is supported.
        alpha: Weight of the variance term.
        beta: Weight of the distance term.
        gamma: Weight of the regularizer.
        ignore_label: Not implemented (as in torch-em).
        impl: Accepted for API parity; the one-hot implementation is always used.
        max_instances: Instance slots per sample; ids from ``max_instances`` on
            are left out of the means, as the JAX package does.
    """

    def __init__(self, delta_var: float, delta_dist: float, norm: str = "fro", alpha: float = 1.0,
                 beta: float = 1.0, gamma: float = 0.001, ignore_label: Optional[int] = None,
                 impl: Optional[str] = None, max_instances: int = 64):
        assert ignore_label is None, "Not implemented"
        assert norm == "fro"
        self.delta_var = delta_var
        self.delta_dist = delta_dist
        self.norm = norm
        self.alpha = alpha
        self.beta = beta
        self.gamma = gamma
        self.ignore_label = ignore_label
        self.max_instances = max_instances
        self.init_kwargs = {"delta_var": delta_var, "delta_dist": delta_dist, "norm": norm,
                            "alpha": alpha, "beta": beta, "gamma": gamma, "ignore_label": ignore_label,
                            "impl": impl, "max_instances": max_instances}

    def _single(self, embeddings, target):
        means, counts = impl.compute_cluster_means(embeddings, target, self.max_instances)
        variance_term = impl.compute_variance_term(means, embeddings, target, counts, self.delta_var)
        distance_term = impl.compute_distance_term(means, counts, self.delta_dist)
        regularization_term = impl.compute_regularizer_term(means, counts)
        return self.alpha * variance_term + self.beta * distance_term + self.gamma * regularization_term

    def __call__(self, input_: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """input_: (N, E, *spatial) embeddings; target: (N, 1, *spatial) instance ids."""
        n_batches = input_.shape[0]
        assert target.ndim == input_.ndim
        assert target.shape[1] == 1
        loss = 0.0
        for b in range(n_batches):
            loss = loss + self._single(input_[b], target[b, 0].long())
        return loss / n_batches
