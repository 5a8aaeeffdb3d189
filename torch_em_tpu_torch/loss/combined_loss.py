"""Weighted combination of losses (reference torch_em/loss/combined_loss.py:6);
the port's counterpart of the JAX package's ``loss/combined_loss.py``."""

from typing import List, Optional

__all__ = ["CombinedLoss"]


class CombinedLoss:
    """Weighted sum of multiple losses (equal weights by default)."""

    def __init__(self, *losses, loss_weights: Optional[List[float]] = None):
        self.losses = list(losses)
        n_losses = len(self.losses)
        if loss_weights is None:
            self.loss_weights = [1.0 / n_losses] * n_losses if n_losses else None
        else:
            assert len(loss_weights) == n_losses
            self.loss_weights = loss_weights
        self.init_kwargs = {"losses": self.losses, "loss_weights": loss_weights}

    def __call__(self, x, y):
        assert self.loss_weights is not None
        total = 0.0
        for loss, weight in zip(self.losses, self.loss_weights):
            total = total + weight * loss(x, y)
        return total
