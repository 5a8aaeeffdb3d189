"""Pseudo-label training with a Shallow2Deep teacher, for domain adaptation.

The port's own copy of ``torch_em_tpu/shallow2deep/pseudolabel_training.py``
(after torch-em's ``shallow2deep/pseudolabel_training.py``): raw-only
datasets and loaders whose labels a ``Shallow2DeepModel`` predicts on the
fly, its forest on the host and its enhancer on ``device``.
"""

from typing import Callable, Optional, Tuple

from ..data import ConcatDataset, DataLoader, PseudoLabelDataset
from ..segmentation import get_data_loader

__all__ = ["get_pseudolabel_dataset", "get_pseudolabel_loader"]


def get_pseudolabel_dataset(
    raw_paths, raw_key,
    checkpoint: str,
    rf_config: Tuple,
    patch_shape: Tuple[int, ...],
    raw_transform: Optional[Callable] = None,
    transform: Optional[Callable] = None,
    rois=None,
    n_samples: Optional[int] = None,
    ndim: Optional[int] = None,
    sampler: Optional[Callable] = None,
    pseudo_label_transform: Optional[Callable] = None,
    device="cuda",
    rf_channel: int = 1,
):
    """A ``PseudoLabelDataset`` (a ``ConcatDataset`` of them for several paths) labelled by
    ``Shallow2DeepModel(checkpoint, rf_config, device)``."""
    from .shallow2deep_model import Shallow2DeepModel

    pseudo_labeler = Shallow2DeepModel(checkpoint, rf_config, device=device, rf_channel=rf_channel)

    def make(rp, roi, n):
        return PseudoLabelDataset(
            rp, raw_key, patch_shape=patch_shape, pseudo_labeler=pseudo_labeler, raw_transform=raw_transform,
            label_transform=pseudo_label_transform, transform=transform, roi=roi, n_samples=n, ndim=ndim,
            sampler=sampler,
        )

    if isinstance(raw_paths, str):
        return make(raw_paths, rois, n_samples)
    return ConcatDataset(*[
        make(rp, None if rois is None else rois[i], None if n_samples is None else n_samples // len(raw_paths))
        for i, rp in enumerate(raw_paths)
    ])


def get_pseudolabel_loader(
    raw_paths, raw_key,
    checkpoint: str,
    rf_config: Tuple,
    batch_size: int,
    patch_shape: Tuple[int, ...],
    **kwargs,
) -> DataLoader:
    """A loader over ``get_pseudolabel_dataset``; ``shuffle``, ``num_workers``, ``drop_last`` and
    ``prefetch_factor`` go to the loader."""
    loader_kwargs = {k: kwargs.pop(k) for k in ("shuffle", "num_workers", "drop_last", "prefetch_factor")
                     if k in kwargs}
    ds = get_pseudolabel_dataset(raw_paths, raw_key, checkpoint, rf_config, patch_shape, **kwargs)
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)
