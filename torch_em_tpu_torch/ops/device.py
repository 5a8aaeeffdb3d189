"""Label targets for a batch, on the labels' own device.

Counterpart of ``torch_em_tpu/ops/device.py``. Affinities and boundaries are
shift-and-compare, so the loader can ship raw instance labels and the
training step derive the targets from them, batched, on the card. Pass a
``DeviceAffinityTransform`` or ``DeviceBoundaryTransform`` to the trainer as
``device_label_transform``. They equal the host ``AffinityTransform`` and
``BoundaryTransform`` (``transforms/label.py``) element for element. They are
plain torch ops: they only compare, so they run unchanged under autocast.
"""

from typing import List, Optional, Sequence

import torch

__all__ = [
    "compute_affinities_batched", "DeviceAffinityTransform", "DeviceBoundaryTransform",
]


def _shift_slices(off, shape):
    """Source and destination slices of one offset (``ops/host.py:compute_affinities``);
    (None, None) when the offset leaves the volume."""
    sl_src, sl_dst = [], []
    for o, s in zip(off, shape):
        if abs(o) >= s:
            return None, None
        if o > 0:
            sl_src.append(slice(None, -o))
            sl_dst.append(slice(o, None))
        elif o < 0:
            sl_src.append(slice(-o, None))
            sl_dst.append(slice(None, o))
        else:
            sl_src.append(slice(None))
            sl_dst.append(slice(None))
    return tuple(sl_src), tuple(sl_dst)


def _labels(y: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B, *spatial) int64 labels from (B, 1, *spatial) or (B, *spatial); floats are
    truncated, as ``astype`` does. CUDA has few uint32 kernels, so every type is cast."""
    y = torch.as_tensor(y)
    if y.ndim == ndim + 2:
        y = y[:, 0]
    return y.to(torch.int64)


def compute_affinities_batched(labels: torch.Tensor, offsets: Sequence[Sequence[int]],
                               have_ignore_label: bool = False, ignore_label: int = 0):
    """(affs, mask), each (B, C, *spatial) float32, from (B, *spatial) labels: per sample
    as ``ops/host.py:compute_affinities``."""
    spatial = labels.shape[1:]
    affs = torch.zeros((labels.shape[0], len(offsets)) + tuple(spatial), dtype=torch.float32,
                       device=labels.device)
    masks = torch.zeros_like(affs)
    for c, off in enumerate(offsets):
        sl_src, sl_dst = _shift_slices(off, spatial)
        if sl_src is None:
            continue
        src = labels[(slice(None),) + sl_src]
        dst = labels[(slice(None),) + sl_dst]
        same = src == dst
        valid = torch.ones_like(same)
        if have_ignore_label:
            valid = (src != ignore_label) & (dst != ignore_label)
            same = same & valid
        affs[(slice(None), c) + sl_src] = same.float()
        masks[(slice(None), c) + sl_src] = valid.float()
    return affs, masks


class DeviceAffinityTransform:
    """Batched ``AffinityTransform`` (disaffinities: 1 at a transition; an optional binary
    channel first and validity-mask channels last), applied to the labels inside the step.

    y in: (B, 1, *spatial) or (B, *spatial) labels; y out: (B, C, *spatial) float32 with
    C = [binary +] offsets [+ masks].
    """

    def __init__(self, offsets: List[List[int]], ignore_label: Optional[int] = None,
                 add_binary_target: bool = False, add_mask: bool = False):
        self.offsets = offsets
        self.ignore_label = ignore_label
        self.add_binary_target = add_binary_target
        self.add_mask = add_mask
        self.init_kwargs = {"offsets": offsets, "ignore_label": ignore_label,
                            "add_binary_target": add_binary_target, "add_mask": add_mask}

    def __call__(self, y):
        labels = _labels(y, len(self.offsets[0]))
        affs, mask = compute_affinities_batched(
            labels, self.offsets,
            have_ignore_label=self.ignore_label is not None,
            ignore_label=0 if self.ignore_label is None else self.ignore_label,
        )
        affs = 1.0 - affs
        if self.add_binary_target:
            affs = torch.cat([(labels != 0).float()[:, None], affs], dim=1)
        if self.add_mask:
            if self.add_binary_target:
                if self.ignore_label is None:
                    mask_bin = torch.ones_like(affs[:, :1])
                else:
                    mask_bin = (labels != self.ignore_label).float()[:, None]
                mask = torch.cat([mask_bin, mask], dim=1)
            affs = torch.cat([affs, mask], dim=1)
        return affs


class DeviceBoundaryTransform:
    """Batched thick boundaries (both voxels of a label transition, as skimage's
    ``find_boundaries(mode="thick")``), with an optional binary channel first."""

    def __init__(self, add_binary_target: bool = False, ndim: Optional[int] = None):
        self.add_binary_target = add_binary_target
        self.ndim = ndim
        self.init_kwargs = {"add_binary_target": add_binary_target, "ndim": ndim}

    def __call__(self, y):
        y = torch.as_tensor(y)
        labels = _labels(y, self.ndim if self.ndim is not None else y.ndim - 2)
        boundary = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
        spatial = labels.shape[1:]
        for axis in range(len(spatial)):
            off = [0] * len(spatial)
            off[axis] = 1
            sl_src, sl_dst = _shift_slices(off, spatial)
            if sl_src is None:
                continue
            diff = labels[(slice(None),) + sl_src] != labels[(slice(None),) + sl_dst]
            boundary[(slice(None),) + sl_src] |= diff
            boundary[(slice(None),) + sl_dst] |= diff
        out = boundary.float()[:, None]
        if self.add_binary_target:
            out = torch.cat([(labels != 0).float()[:, None], out], dim=1)
        return out
