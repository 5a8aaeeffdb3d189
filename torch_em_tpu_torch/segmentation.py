"""Factory API: the dataset, loader and trainer factories.

The port's own copy of ``torch_em_tpu/segmentation.py`` (after torch-em's
``segmentation.py``). ``default_segmentation_dataset`` sniffs the data
(volumes that ``load_data`` opens, image collections, in-memory arrays),
builds the dataset with the default raw transform and augmentations, and
``default_segmentation_loader`` wraps it into the port's thread
``DataLoader``. ``default_segmentation_trainer`` builds an AdamW
``OptimizerSpec`` at ``learning_rate``, a ``ReduceLROnPlateau`` with
``scheduler_kwargs``, and ``DiceLoss`` as loss and metric unless given; it
runs on ``device="cuda"`` unless asked otherwise, and its ``logger``
defaults to ``TensorboardLogger``, as in the JAX package (event files under
``<save_root>/logs/<name>``, written by the port itself).
"""

import os
from glob import glob
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from .data import ConcatDataset, DataLoader, ImageCollectionDataset, SegmentationDataset, TensorDataset
from .loss import DiceLoss
from .trainer import DefaultTrainer, OptimizerSpec, ReduceLROnPlateau, TensorboardLogger
from .transforms import get_augmentations, get_raw_transform
from .utils.io import load_data

__all__ = [
    "default_segmentation_dataset", "default_segmentation_loader", "default_segmentation_trainer",
    "get_data_loader", "DEFAULT_SCHEDULER_KWARGS",
]

DEFAULT_SCHEDULER_KWARGS = {"mode": "min", "factor": 0.5, "patience": 5}


def samples_to_datasets(n_samples, raw_paths, raw_key, split="uniform"):
    """@private"""
    assert split in ("balanced", "uniform")
    n_datasets = len(raw_paths)
    if split == "uniform":
        samples_per_ds = n_samples // n_datasets
        divider = n_samples % n_datasets
        return [samples_per_ds + 1 if ii < divider else samples_per_ds for ii in range(n_datasets)]
    raise NotImplementedError


def check_paths(raw_paths, label_paths):
    """@private"""
    if not isinstance(raw_paths, type(label_paths)):
        raise ValueError(f"Expect raw and label paths of same type, got {type(raw_paths)}, {type(label_paths)}")
    if isinstance(raw_paths, list) and len(raw_paths) > 0 and isinstance(raw_paths[0], np.ndarray):
        return

    def _check_path(path):
        if isinstance(path, str):
            if not os.path.exists(path):
                raise ValueError(f"Could not find path {path}")
        else:
            for per_path in path:
                if not os.path.exists(per_path):
                    raise ValueError(f"Could not find path {per_path}")

    if isinstance(raw_paths, str):
        _check_path(raw_paths)
        _check_path(label_paths)
    else:
        if len(raw_paths) != len(label_paths):
            raise ValueError(f"Expect same number of raw and label paths, got {len(raw_paths)}, {len(label_paths)}")
        for rp, lp in zip(raw_paths, label_paths):
            _check_path(rp)
            _check_path(lp)


def is_segmentation_dataset(raw_paths, raw_key, label_paths, label_key):
    """@private — can the data be opened as container datasets?"""
    if isinstance(raw_paths, list) and len(raw_paths) > 0 and isinstance(raw_paths[0], np.ndarray):
        if not all(isinstance(rp, np.ndarray) for rp in raw_paths):
            raise ValueError("Inconsistent raw data")
        if not all(isinstance(lp, np.ndarray) for lp in label_paths):
            raise ValueError("Inconsistent label data")
        return False

    def _can_open(path, key):
        try:
            load_data(path, key)
            return True
        except Exception:
            return False

    if isinstance(raw_paths, str):
        can_open_raw = _can_open(raw_paths, raw_key)
        can_open_label = _can_open(label_paths, label_key)
    else:
        can_open_raw_list = [_can_open(rp, raw_key) for rp in raw_paths]
        if can_open_raw_list.count(can_open_raw_list[0]) != len(can_open_raw_list):
            raise ValueError("Inconsistent raw data")
        can_open_raw = can_open_raw_list[0]
        can_open_label_list = [_can_open(lp, label_key) for lp in label_paths]
        if can_open_label_list.count(can_open_label_list[0]) != len(can_open_label_list):
            raise ValueError("Inconsistent label data")
        can_open_label = can_open_label_list[0]

    if can_open_raw != can_open_label:
        raise ValueError("Inconsistent raw and label data")
    return can_open_raw


def _load_segmentation_dataset(raw_paths, raw_key, label_paths, label_key, **kwargs):
    rois = kwargs.pop("rois", None)
    if isinstance(raw_paths, str):
        if rois is not None:
            assert isinstance(rois, (tuple, slice))
            if isinstance(rois, tuple):
                assert all(isinstance(roi, slice) for roi in rois)
        return SegmentationDataset(raw_paths, raw_key, label_paths, label_key, roi=rois, **kwargs)
    assert len(raw_paths) > 0
    if rois is not None:
        assert len(rois) == len(label_paths)
        assert all(isinstance(roi, tuple) for roi in rois), f"{rois}"
    n_samples = kwargs.pop("n_samples", None)
    samples_per_ds = (
        [None] * len(raw_paths) if n_samples is None else samples_to_datasets(n_samples, raw_paths, raw_key)
    )
    ds = []
    for i, (raw_path, label_path) in enumerate(zip(raw_paths, label_paths)):
        roi = None if rois is None else rois[i]
        ds.append(SegmentationDataset(
            raw_path, raw_key, label_path, label_key, roi=roi, n_samples=samples_per_ds[i], **kwargs
        ))
    return ConcatDataset(*ds)


def _load_image_collection_dataset(raw_paths, raw_key, label_paths, label_key, roi, with_channels, **kwargs):
    if isinstance(raw_paths, list) and len(raw_paths) > 0 and isinstance(raw_paths[0], np.ndarray):
        assert raw_key is None and label_key is None
        assert roi is None
        kwargs.pop("pre_label_transform", None)  # TensorDataset does not support pre-label transforms
        return TensorDataset(raw_paths, label_paths, with_channels=with_channels, **kwargs)

    def _get_paths(rpath, rkey, lpath, lkey, this_roi):
        rfiles = sorted(glob(os.path.join(rpath, rkey)))
        if len(rfiles) == 0:
            raise ValueError(f"Could not find any images for pattern {os.path.join(rpath, rkey)}")
        lfiles = sorted(glob(os.path.join(lpath, lkey)))
        if len(rfiles) != len(lfiles):
            raise ValueError(f"Expect same number of raw and label images, got {len(rfiles)}, {len(lfiles)}")
        if this_roi is not None:
            rfiles, lfiles = rfiles[this_roi], lfiles[this_roi]
        return rfiles, lfiles

    patch_shape = kwargs.pop("patch_shape")
    if patch_shape is not None:
        if len(patch_shape) == 3:
            if patch_shape[0] != 1:
                raise ValueError(f"Image collection dataset expects 2d patch shape, got {patch_shape}")
            patch_shape = patch_shape[1:]
        assert len(patch_shape) == 2

    if isinstance(raw_paths, str):
        raw_files, label_files = _get_paths(raw_paths, raw_key, label_paths, label_key, roi)
        return ImageCollectionDataset(raw_files, label_files, patch_shape=patch_shape, **kwargs)
    if raw_key is None:
        assert label_key is None
        assert isinstance(raw_paths, (list, tuple)) and isinstance(label_paths, (list, tuple))
        assert len(raw_paths) == len(label_paths)
        return ImageCollectionDataset(raw_paths, label_paths, patch_shape=patch_shape, **kwargs)

    ds = []
    n_samples = kwargs.pop("n_samples", None)
    samples_per_ds = (
        [None] * len(raw_paths) if n_samples is None else samples_to_datasets(n_samples, raw_paths, raw_key)
    )
    if roi is None:
        roi = len(raw_paths) * [None]
    assert len(roi) == len(raw_paths)
    for i, (raw_path, label_path, this_roi) in enumerate(zip(raw_paths, label_paths, roi)):
        rfiles, lfiles = _get_paths(raw_path, raw_key, label_path, label_key, this_roi)
        ds.append(ImageCollectionDataset(
            rfiles, lfiles, patch_shape=patch_shape, n_samples=samples_per_ds[i], **kwargs
        ))
    return ConcatDataset(*ds)


def _get_default_transform(path, key, is_seg_dataset, ndim):
    if is_seg_dataset and ndim is None:
        shape = load_data(path, key).shape
        if len(shape) == 2:
            ndim = 2
        else:
            # heuristic: use anisotropic augmentations for flat 3d volumes
            ndim = "anisotropic" if shape[0] < shape[1] // 2 else 3
    elif is_seg_dataset and ndim is not None:
        pass
    else:
        ndim = 2
    return get_augmentations(ndim)


def default_segmentation_dataset(
    raw_paths: Union[List[Any], str, os.PathLike],
    raw_key: Optional[str],
    label_paths: Union[List[Any], str, os.PathLike],
    label_key: Optional[str],
    patch_shape: Tuple[int, ...],
    label_transform: Optional[Callable] = None,
    label_transform2: Optional[Callable] = None,
    raw_transform: Optional[Callable] = None,
    transform: Optional[Callable] = None,
    dtype="float32",
    label_dtype="float32",
    rois=None,
    n_samples: Optional[int] = None,
    sampler: Optional[Callable] = None,
    ndim: Optional[int] = None,
    is_seg_dataset: Optional[bool] = None,
    with_channels: bool = False,
    with_label_channels: bool = False,
    verify_paths: bool = True,
    with_padding: bool = True,
    z_ext: Optional[int] = None,
    pre_label_transform: Optional[Callable] = None,
):
    """A dataset for training a segmentation network (torch-em segmentation.py:320): a
    ``SegmentationDataset`` (a ``ConcatDataset`` of them for several paths) where the data
    opens as volumes, else an ``ImageCollectionDataset`` (image files, a folder and a glob
    pattern as key) or a ``TensorDataset`` (numpy arrays); ``get_raw_transform()`` and
    the default augmentations of ``ndim`` unless given."""
    if verify_paths:
        check_paths(raw_paths, label_paths)
    if is_seg_dataset is None:
        is_seg_dataset = is_segmentation_dataset(raw_paths, raw_key, label_paths, label_key)
    if raw_transform is None:
        raw_transform = get_raw_transform()
    if transform is None:
        transform = _get_default_transform(
            raw_paths if isinstance(raw_paths, str) else raw_paths[0], raw_key, is_seg_dataset, ndim
        )

    if is_seg_dataset:
        return _load_segmentation_dataset(
            raw_paths, raw_key, label_paths, label_key,
            patch_shape=patch_shape, raw_transform=raw_transform, label_transform=label_transform,
            label_transform2=label_transform2, transform=transform, rois=rois, n_samples=n_samples,
            sampler=sampler, ndim=ndim, dtype=dtype, label_dtype=label_dtype,
            with_channels=with_channels, with_label_channels=with_label_channels,
            with_padding=with_padding, z_ext=z_ext, pre_label_transform=pre_label_transform,
        )
    return _load_image_collection_dataset(
        raw_paths, raw_key, label_paths, label_key, roi=rois,
        patch_shape=patch_shape, label_transform=label_transform, raw_transform=raw_transform,
        label_transform2=label_transform2, transform=transform, n_samples=n_samples, sampler=sampler,
        dtype=dtype, label_dtype=label_dtype, with_padding=with_padding, with_channels=with_channels,
        pre_label_transform=pre_label_transform,
    )


def get_data_loader(dataset, batch_size: int, **loader_kwargs) -> DataLoader:
    """@private"""
    loader_kwargs.pop("pin_memory", None)  # the trainer stages its batches itself
    return DataLoader(dataset, batch_size=batch_size, **loader_kwargs)


def default_segmentation_loader(
    raw_paths,
    raw_key,
    label_paths,
    label_key,
    batch_size: int,
    patch_shape: Tuple[int, ...],
    label_transform: Optional[Callable] = None,
    label_transform2: Optional[Callable] = None,
    raw_transform: Optional[Callable] = None,
    transform: Optional[Callable] = None,
    dtype="float32",
    label_dtype="float32",
    rois=None,
    n_samples: Optional[int] = None,
    sampler: Optional[Callable] = None,
    ndim: Optional[int] = None,
    is_seg_dataset: Optional[bool] = None,
    with_channels: bool = False,
    with_label_channels: bool = False,
    verify_paths: bool = True,
    with_padding: bool = True,
    z_ext: Optional[int] = None,
    pre_label_transform: Optional[Callable] = None,
    **loader_kwargs,
) -> DataLoader:
    """A thread ``DataLoader`` over ``default_segmentation_dataset`` (torch-em
    segmentation.py:222)."""
    ds = default_segmentation_dataset(
        raw_paths=raw_paths, raw_key=raw_key, label_paths=label_paths, label_key=label_key,
        patch_shape=patch_shape, label_transform=label_transform, label_transform2=label_transform2,
        raw_transform=raw_transform, transform=transform, dtype=dtype, label_dtype=label_dtype,
        rois=rois, n_samples=n_samples, sampler=sampler, ndim=ndim, is_seg_dataset=is_seg_dataset,
        with_channels=with_channels, with_label_channels=with_label_channels,
        verify_paths=verify_paths, with_padding=with_padding, z_ext=z_ext,
        pre_label_transform=pre_label_transform,
    )
    return get_data_loader(ds, batch_size=batch_size, **loader_kwargs)


def default_segmentation_trainer(
    name: str,
    model,
    train_loader,
    val_loader,
    loss=None,
    metric=None,
    learning_rate: float = 1e-3,
    device="cuda",
    log_image_interval: int = 100,
    mixed_precision: bool = True,
    early_stopping: Optional[int] = None,
    logger=TensorboardLogger,
    logger_kwargs: Optional[Dict[str, Any]] = None,
    scheduler_kwargs: Optional[Dict[str, Any]] = None,
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    trainer_class=DefaultTrainer,
    id_: Optional[str] = None,
    save_root: Optional[str] = None,
    compile_model=None,
    rank: Optional[int] = None,
    steps_per_execution: int = 1,
    device_label_transform=None,
):
    """A trainer for a segmentation network: AdamW, plateau scheduler, Dice loss and metric."""
    optimizer = OptimizerSpec("adamw", lr=learning_rate, **(optimizer_kwargs or {}))
    scheduler = ReduceLROnPlateau(**(DEFAULT_SCHEDULER_KWARGS if scheduler_kwargs is None
                                     else scheduler_kwargs))
    trainer_kwargs = dict(
        name=name, model=model, train_loader=train_loader, val_loader=val_loader,
        loss=DiceLoss() if loss is None else loss, metric=DiceLoss() if metric is None else metric,
        optimizer=optimizer, device=device, lr_scheduler=scheduler,
        mixed_precision=mixed_precision, early_stopping=early_stopping,
        log_image_interval=log_image_interval, logger=logger, logger_kwargs=logger_kwargs,
        id_=id_, save_root=save_root, compile_model=compile_model, rank=rank,
        steps_per_execution=steps_per_execution,
    )
    # forwarded only when set, so that a trainer_class that binds it itself takes no second copy
    if device_label_transform is not None:
        trainer_kwargs["device_label_transform"] = device_label_transform
    return trainer_class(**trainer_kwargs)
