"""The exponential moving average of one network's state into another's.

Shared by ``SPOCOTrainer`` (its ``model2``) and the self-training trainers
(their teacher). As the JAX package's ``tree_map`` over all variables, every
parameter and floating buffer of the target becomes ``t * momentum + s * (1 -
momentum)`` of itself (t) and the source (s); integer buffers are copied. The
update runs on the device with ``torch._foreach_*``, so it waits for nothing.
"""

from typing import List

import torch

__all__ = ["MovingAverage"]


class MovingAverage:
    """Pairs of the target's and the source's tensors, in state-dict order, and their update.

    Args:
        target: The network that holds the average.
        source: The network averaged into it, with the same state-dict keys.
    """

    def __init__(self, target: torch.nn.Module, source: torch.nn.Module):
        targets = target.state_dict(keep_vars=True)
        sources = source.state_dict(keep_vars=True)
        self.floats: List[List[torch.Tensor]] = [[], []]
        self.ints: List[List[torch.Tensor]] = [[], []]
        for name, t in targets.items():
            pair = self.floats if t.is_floating_point() else self.ints
            pair[0].append(t.data)
            pair[1].append(sources[name].data)

    @torch.no_grad()
    def update(self, momentum: float):
        """target <- target * momentum + source * (1 - momentum), on the device."""
        target, source = self.floats
        torch._foreach_mul_(target, momentum)
        torch._foreach_add_(target, source, alpha=1.0 - momentum)
        for t, s in zip(*self.ints):
            t.copy_(s)
