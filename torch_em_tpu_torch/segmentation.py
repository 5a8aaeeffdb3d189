"""Factory API: ``default_segmentation_trainer``.

Counterpart of ``default_segmentation_trainer`` in
``torch_em_tpu/segmentation.py``: an AdamW ``OptimizerSpec`` at
``learning_rate``, a ``ReduceLROnPlateau`` with ``scheduler_kwargs``, and
``DiceLoss`` as loss and metric unless given. The port runs on
``device="cuda"`` unless asked otherwise, and its ``logger`` defaults to
None (no tensorboard on the machine with the card). The JAX package's
dataset and loader factories read container and image files that the port
cannot read yet; they wait for a later slice.
"""

from typing import Any, Dict, Optional

from .loss import DiceLoss
from .trainer import DefaultTrainer, OptimizerSpec, ReduceLROnPlateau

__all__ = ["default_segmentation_trainer", "DEFAULT_SCHEDULER_KWARGS"]

DEFAULT_SCHEDULER_KWARGS = {"mode": "min", "factor": 0.5, "patience": 5}


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
    logger=None,
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
