"""Optimizer specs and the plateau learning-rate scheduler.

Counterpart of ``torch_em_tpu/trainer/optimizers.py``. ``OptimizerSpec``
describes an optimizer by name and keyword arguments (so a checkpoint can
rebuild it) and ``build(params)`` makes the ``torch.optim`` optimizer. The
JAX package builds optax transformations; the port passes optax's defaults
where torch's differ, so one spec means one update rule on both sides:

- ``adamw``: optax's ``weight_decay=1e-4`` (torch's default is 1e-2), and
  every parameter decays, biases too (optax's ``mask=None``);
- ``adam``: optax's ``b1``, ``b2`` and ``eps`` become torch's ``betas`` and
  ``eps``;
- ``sgd``: optax's ``momentum=None`` is torch's ``momentum=0``.

optax's rmsprop, adagrad, lamb and lion have no torch counterpart with the
same update rule and are not ported yet. ``grad_clip`` clips by the global
norm as ``optax.clip_by_global_norm`` does; the trainer calls
:meth:`OptimizerSpec.clip_gradients` before each step.

``ReduceLROnPlateau`` steps once per epoch on the validation metric (lower
is better) and scales ``param_group["lr"]`` of the trainer's optimizer.
"""

from typing import Any, Dict, Iterable, Optional

import torch

__all__ = ["OptimizerSpec", "ReduceLROnPlateau", "get_learning_rate", "set_learning_rate"]


def _adam_kwargs(b1=0.9, b2=0.999, eps=1e-8, **kwargs):
    return {"betas": (b1, b2), "eps": eps, **kwargs}


def _adamw(params, lr, weight_decay=1e-4, **kwargs):
    return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay, **_adam_kwargs(**kwargs))


def _adam(params, lr, **kwargs):
    return torch.optim.Adam(params, lr=lr, **_adam_kwargs(**kwargs))


def _sgd(params, lr, momentum=None, nesterov=False):
    return torch.optim.SGD(params, lr=lr, momentum=momentum or 0.0, nesterov=nesterov)


_OPTIMIZERS = {"adam": _adam, "adamw": _adamw, "sgd": _sgd}
_NOT_PORTED = ("rmsprop", "adagrad", "lamb", "lion")


class OptimizerSpec:
    """Serializable optimizer description; ``build(params)`` makes the torch optimizer."""

    def __init__(self, name: str = "adamw", lr: float = 1e-4, grad_clip: Optional[float] = None, **kwargs):
        if name.lower() in _NOT_PORTED:
            raise NotImplementedError(
                f"optimizer {name!r} is not ported yet (ROADMAP.md); use one of {sorted(_OPTIMIZERS)}")
        if name.lower() not in _OPTIMIZERS:
            raise ValueError(f"Unknown optimizer {name}; available: {sorted(_OPTIMIZERS)}")
        self.name = name.lower()
        self.lr = lr
        self.grad_clip = grad_clip
        self.kwargs = kwargs
        self.init_kwargs = {"name": name, "lr": lr, "grad_clip": grad_clip, **kwargs}

    def build(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        return _OPTIMIZERS[self.name](params, self.lr, **self.kwargs)

    def clip_gradients(self, params: Iterable[torch.nn.Parameter]):
        """Scale the gradients by ``grad_clip / norm`` where their global norm exceeds ``grad_clip``."""
        if self.grad_clip is None:
            return
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        for g in grads:
            g.mul_(scale)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


class ReduceLROnPlateau:
    """Plateau learning-rate scheduler (torch ReduceLROnPlateau semantics).

    ``step(metric)`` is called once per epoch with the validation metric;
    after more than ``patience`` epochs without an improvement by
    ``threshold`` the learning rate of the attached trainer's optimizer is
    scaled by ``factor``, down to ``min_lr``.
    """

    def __init__(self, mode: str = "min", factor: float = 0.5, patience: int = 5,
                 threshold: float = 1e-4, threshold_mode: str = "rel",
                 min_lr: float = 0.0, verbose: bool = False):
        if mode not in ("min", "max") or threshold_mode not in ("rel", "abs"):
            raise ValueError(f"invalid mode {mode!r} or threshold_mode {threshold_mode!r}")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.min_lr = min_lr
        self.verbose = verbose
        self.best: Optional[float] = None
        self.num_bad_epochs = 0
        self._trainer = None
        self.init_kwargs = {
            "mode": mode, "factor": factor, "patience": patience, "threshold": threshold,
            "threshold_mode": threshold_mode, "min_lr": min_lr, "verbose": verbose,
        }

    def attach(self, trainer):
        """Act on ``trainer.torch_optimizer``."""
        self._trainer = trainer
        return self

    def _is_better(self, current: float) -> bool:
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            if self.mode == "min":
                return current < self.best * (1.0 - self.threshold)
            return current > self.best * (1.0 + self.threshold)
        if self.mode == "min":
            return current < self.best - self.threshold
        return current > self.best + self.threshold

    def step(self, metric: float):
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            if self._trainer is not None:
                optimizer = self._trainer.torch_optimizer
                old_lr = get_learning_rate(optimizer)
                new_lr = max(old_lr * self.factor, self.min_lr)
                if new_lr < old_lr:
                    set_learning_rate(optimizer, new_lr)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: reducing learning rate to {new_lr:.3e}")

    def state_dict(self) -> Dict[str, Any]:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, state: Dict[str, Any]):
        self.best = state.get("best")
        self.num_bad_epochs = state.get("num_bad_epochs", 0)
