"""Training summary reports.

The port's own copy of ``torch_em_tpu/utils/reporting.py`` (after torch-em's
``util/reporting.py``).
"""

from typing import Optional

__all__ = ["get_training_summary"]


def _count(ds) -> int:
    return len(ds.raw_images) if hasattr(ds, "raw_images") else 1


def _get_n_images(loader) -> str:
    dataset = loader.dataset
    if hasattr(dataset, "datasets"):
        return str(sum(_count(ds) for ds in dataset.datasets))
    return str(_count(dataset))


def _get_training_summary(trainer, lr):
    return {
        "n_iterations": trainer.iteration,
        "batch_size": trainer.train_loader.batch_size,
        "loss": type(trainer.loss).__name__,
        "optimizer": getattr(trainer.optimizer, "name", "adamw"),
        "learning_rate": lr,
        "n_train_images": _get_n_images(trainer.train_loader),
        "n_val_images": _get_n_images(trainer.val_loader),
    }


def get_training_summary(trainer, lr: Optional[float] = None, to_md: bool = False, lower_case: bool = False):
    """A summary of a training run, as a dict or, with ``to_md``, as markdown. ``lr`` defaults
    to the optimizer's current learning rate."""
    if lr is None:
        if trainer.torch_optimizer is not None:
            from ..trainer.optimizers import get_learning_rate

            lr = get_learning_rate(trainer.torch_optimizer)
        else:
            lr = getattr(trainer.optimizer, "lr", None)
    summary = _get_training_summary(trainer, lr)
    if lower_case:
        summary = {k.lower(): v for k, v in summary.items()}
    if not to_md:
        return summary
    lines = ["# Training Summary", ""]
    for k, v in summary.items():
        lines.append(f"- **{k}**: {v}")
    return "\n".join(lines)
