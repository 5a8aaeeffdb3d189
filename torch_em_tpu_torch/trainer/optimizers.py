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
- ``sgd``: optax's ``momentum=None`` is torch's ``momentum=0``;
- ``rmsprop``, ``adagrad``, ``lamb`` and ``lion``: torch's own optimizers of
  these names follow other update rules (torch's RMSprop adds ``eps``
  outside the square root, its Adagrad starts the sum of squares at 0, it
  has no LAMB, and no Lion), so the port has its own ``torch.optim.Optimizer``
  for each, with optax's update rule, defaults and arguments.

``grad_clip`` clips by the global norm as ``optax.clip_by_global_norm``
does; the trainer calls :meth:`OptimizerSpec.clip_gradients` before each
step.

``ReduceLROnPlateau`` steps once per epoch on the validation metric (lower
is better) and scales ``param_group["lr"]`` of the trainer's optimizer.
"""

from typing import Any, Dict, Iterable, Optional

import torch

__all__ = ["OptimizerSpec", "ReduceLROnPlateau", "get_learning_rate", "set_learning_rate",
           "OptaxRMSProp", "OptaxAdagrad", "OptaxLamb", "OptaxLion"]


def _adam_kwargs(b1=0.9, b2=0.999, eps=1e-8, **kwargs):
    return {"betas": (b1, b2), "eps": eps, **kwargs}


def _adamw(params, lr, weight_decay=1e-4, **kwargs):
    return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay, **_adam_kwargs(**kwargs))


def _adam(params, lr, **kwargs):
    return torch.optim.Adam(params, lr=lr, **_adam_kwargs(**kwargs))


def _sgd(params, lr, momentum=None, nesterov=False):
    return torch.optim.SGD(params, lr=lr, momentum=momentum or 0.0, nesterov=nesterov)


class _OptaxOptimizer(torch.optim.Optimizer):
    """An optax update rule as a torch optimizer: ``_update(p, g, state, group)`` returns the
    update (optax's sign convention, already scaled by the learning rate), which is added to
    ``p``; ``state["step"]`` counts the steps, as optax's ``count``."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    self._init_state(p, state, group)
                state["step"] += 1
                p.add_(self._update(p, p.grad, state, group))
        return loss


class OptaxRMSProp(_OptaxOptimizer):
    """``optax.rmsprop``: ``scale_by_rms`` (or ``scale_by_stddev`` when ``centered``), the learning
    rate, then an optional ``trace`` (momentum) of the scaled updates."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True, centered=False,
                 momentum=None, nesterov=False, bias_correction=False):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, initial_scale=initial_scale,
                                      eps_in_sqrt=eps_in_sqrt, centered=centered, momentum=momentum,
                                      nesterov=nesterov, bias_correction=bias_correction))

    def _init_state(self, p, state, group):
        state["nu"] = torch.full_like(p, group["initial_scale"])
        if group["centered"]:
            state["mu"] = torch.zeros_like(p)
        if group["momentum"] is not None:
            state["trace"] = torch.zeros_like(p)

    def _update(self, p, g, state, group):
        decay = group["decay"]
        nu = state["nu"].mul_(decay).add_((1 - decay) * g ** 2)
        count = float(state["step"])
        correction = 1 - decay ** count if group["bias_correction"] else 1.0
        second = nu / correction
        if group["centered"]:
            mu = state["mu"].mul_(decay).add_((1 - decay) * g)
            second = second - (mu / correction) ** 2
        if group["eps_in_sqrt"]:
            scaling = torch.rsqrt(second + group["eps"])
        else:
            scaling = 1 / (torch.sqrt(second) + group["eps"])
        update = -group["lr"] * (scaling * g)
        if group["momentum"] is not None:
            trace = state["trace"].mul_(group["momentum"]).add_(update)
            update = update + group["momentum"] * trace if group["nesterov"] else trace.clone()
        return update


class OptaxAdagrad(_OptaxOptimizer):
    """``optax.adagrad``: the sum of squared gradients starts at ``initial_accumulator_value``, and the
    update is ``-lr * g / sqrt(sum + eps)`` (0 where the sum is 0)."""

    def __init__(self, params, lr, initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value, eps=eps))

    def _init_state(self, p, state, group):
        state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])

    def _update(self, p, g, state, group):
        total = state["sum_of_squares"].add_(g ** 2)
        inv = torch.where(total > 0, torch.rsqrt(total + group["eps"]), torch.zeros_like(total))
        return -group["lr"] * (inv * g)


class OptaxLamb(_OptaxOptimizer):
    """``optax.lamb``: Adam's bias-corrected update, plus ``weight_decay * p``, scaled per tensor by
    the trust ratio ``|p| / |update|`` (1 where either norm is 0), then by the learning rate."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay))

    def _init_state(self, p, state, group):
        state["mu"] = torch.zeros_like(p)
        state["nu"] = torch.zeros_like(p)

    def _update(self, p, g, state, group):
        b1, b2 = group["b1"], group["b2"]
        mu = state["mu"].mul_(b1).add_((1 - b1) * g)
        nu = state["nu"].mul_(b2).add_((1 - b2) * g ** 2)
        count = float(state["step"])
        mu_hat, nu_hat = mu / (1 - b1 ** count), nu / (1 - b2 ** count)
        update = mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) + group["eps"]) + group["weight_decay"] * p
        p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(update)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm), p_norm / u_norm)
        return -group["lr"] * (update * ratio)


class OptaxLion(_OptaxOptimizer):
    """``optax.lion``: ``sign((1 - b1) * g + b1 * m)`` plus ``weight_decay * p``, by the learning
    rate; then ``m <- (1 - b2) * g + b2 * m``."""

    def __init__(self, params, lr, b1=0.9, b2=0.99, weight_decay=1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, weight_decay=weight_decay))

    def _init_state(self, p, state, group):
        state["mu"] = torch.zeros_like(p)

    def _update(self, p, g, state, group):
        b1, b2 = group["b1"], group["b2"]
        direction = torch.sign((1 - b1) * g + b1 * state["mu"])
        state["mu"].mul_(b2).add_((1 - b2) * g)
        return -group["lr"] * (direction + group["weight_decay"] * p)


_OPTIMIZERS = {"adam": _adam, "adamw": _adamw, "sgd": _sgd, "rmsprop": OptaxRMSProp, "adagrad": OptaxAdagrad,
               "lamb": OptaxLamb, "lion": OptaxLion}


class OptimizerSpec:
    """Serializable optimizer description; ``build(params)`` makes the torch optimizer."""

    def __init__(self, name: str = "adamw", lr: float = 1e-4, grad_clip: Optional[float] = None, **kwargs):
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
