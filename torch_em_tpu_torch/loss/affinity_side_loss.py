"""Affinity side loss: embeddings vs. segmentation-derived affinities.

The port's counterpart of the JAX package's ``loss/affinity_side_loss.py``
(torch-em's ``loss/affinity_side_loss.py``): ``shift_tensor``,
``segmentation_to_affinities``, ``embeddings_to_affinities`` and
``AffinitySideLoss``, which draws ``n_samples`` random offsets per call
(numpy's global generator, as torch-em does) and takes the Dice loss of the
inverted affinities. A shift reads ``input[clamp(x - offset)]`` on every
spatial axis: the edge is replicated, as torch-em's replication pad and
slice do.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .dice import dice_score

__all__ = ["AffinitySideLoss", "shift_tensor", "segmentation_to_affinities", "embeddings_to_affinities"]


def _read_shifted(tensor: torch.Tensor, offset: Sequence[int]) -> torch.Tensor:
    """``out[x] = tensor[clamp(x + offset)]`` over the trailing ``len(offset)`` axes."""
    lead = tensor.ndim - len(offset)
    for axis, off in enumerate(offset):
        off = int(off)
        if off == 0:
            continue
        size = tensor.shape[lead + axis]
        index = (torch.arange(size, device=tensor.device) + off).clamp_(0, size - 1)
        tensor = tensor.index_select(lead + axis, index)
    return tensor


def shift_tensor(tensor: torch.Tensor, offset: List[int]) -> torch.Tensor:
    """Shift a tensor by a spatial offset (reference :9): ``out[x] = tensor[x - offset]``
    with edge replication, so a negative offset shifts content left."""
    return _read_shifted(tensor, [-int(o) for o in offset])


def segmentation_to_affinities(segmentation: torch.Tensor, offsets) -> torch.Tensor:
    """Affinities from a segmentation via shift-and-compare (reference :70).

    segmentation: (N, 1, *spatial); returns (N, n_offsets, *spatial) with
    1 = same segment.
    """
    assert segmentation.shape[1] == 1, f"{segmentation.shape}"
    seg = segmentation.float()
    shifted = torch.cat([_read_shifted(seg, off) for off in offsets], dim=1)
    return ((seg - shifted) == 0).float()


def embeddings_to_affinities(embeddings: torch.Tensor, offsets, delta: float) -> torch.Tensor:
    """Affinities from embeddings (reference :92): hinge of the embedding
    distance, ``clamp((2d - |e_x - e_{x+off}|) / 2d, 0)^2``."""
    shifted = torch.stack([_read_shifted(embeddings, off) for off in offsets], dim=1)
    affs = (2 * delta - torch.linalg.vector_norm(embeddings[:, None] - shifted, dim=2)) / (2 * delta)
    return affs.clamp(min=0) ** 2


class AffinitySideLoss:
    """Dice between affinities from embeddings and from the target segmentation
    (reference affinity_side_loss.py:114); offsets resampled per call."""

    def __init__(self, offset_ranges: List[Tuple[int, int]], n_samples: int, delta: float):
        assert all(len(orange) == 2 for orange in offset_ranges)
        self.ndim = len(offset_ranges)
        self.offset_ranges = offset_ranges
        self.n_samples = n_samples
        self.delta = delta
        self.init_kwargs = {"offset_ranges": offset_ranges, "n_samples": n_samples, "delta": delta}

    def _sample_offsets(self) -> np.ndarray:
        """(n_samples, ndim) offsets, each axis drawn from [low, high)."""
        return np.stack([np.random.randint(lo, hi, size=self.n_samples) for lo, hi in self.offset_ranges],
                        axis=1)

    def __call__(self, input_, target):
        assert input_.ndim == target.ndim, f"{input_.ndim}, {target.ndim}"
        assert input_.shape[2:] == target.shape[2:]
        # the shifts read at the inverted offsets (reference :85, :105)
        inverted = [[-int(o) for o in off] for off in self._sample_offsets()]
        affs = 1.0 - embeddings_to_affinities(input_, inverted, self.delta)
        target_affs = 1.0 - segmentation_to_affinities(target, inverted)
        assert affs.shape == target_affs.shape, f"{affs.shape}, {target_affs.shape}"
        return dice_score(affs, target_affs, invert=True)
