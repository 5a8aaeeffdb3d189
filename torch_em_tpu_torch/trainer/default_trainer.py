"""DefaultTrainer: the training loop.

Counterpart of ``torch_em_tpu/trainer/default_trainer.py`` (itself torch-em's
``trainer/default_trainer.py``), with the same semantics:

- ``fit(iterations=...)`` or ``fit(epochs=...)``; each epoch trains, then
  validates, then steps the ``lr_scheduler`` on the validation metric (lower
  is better), then writes the ``best``, ``latest`` and, with
  ``save_every_kth_epoch``, ``epoch-<k>`` checkpoints, then checks early
  stopping;
- resume with ``fit(..., load_from_checkpoint="latest")``, or skip a finished
  run with ``overwrite_training=False``;
- a checkpoint is a ``torch.save`` dict with the JAX package's keys
  (``iteration``, ``epoch``, ``best_epoch``, ``best_metric``,
  ``current_metric``, ``train_time``, ``model_state``, ``optimizer_state``,
  ``init``, ``scheduler_state``), where ``init`` is the JSON spec of every
  constructor argument, so ``from_checkpoint`` rebuilds a trainer that can go
  on training;
- ``device_label_transform`` turns the loader's labels into targets inside
  the step, on the device;
- ``mixed_precision`` computes in bfloat16 with float32 parameters: the
  model's compute ``dtype`` is bfloat16 for the duration of each forward, as
  the JAX package's ``_module_for_compute`` clones its module. bf16 has
  float32's range, so no gradient scaler is needed.

The step is eager PyTorch: forward, ``loss.backward()``, optimizer step.
``steps_per_execution=k`` is accepted and runs its k steps one by one; the
JAX package stages k batches into one ``lax.scan`` to save TPU dispatches,
and that scan computes the same k steps in order. Progress is reported with
plain prints. The logger defaults to ``None`` (see ``logger_base``).
"""

import contextlib
import json
import os
import time
import warnings
from datetime import datetime
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..models.base import resolve_device
from .optimizers import OptimizerSpec, ReduceLROnPlateau, get_learning_rate
from .serialization import deserialize_value, resolve_path, serialize_value, serialize_value_or_pickle

__all__ = ["DefaultTrainer"]


class DefaultTrainer:
    """Trainer for a segmentation network.

    Args:
        name: The name of the checkpoint that will be created by the trainer.
        train_loader: The data loader containing the training data.
        val_loader: The data loader containing the validation data.
        model: The model to train (an ``nn.Module``; one of the port's U-Net
            factories records what ``from_checkpoint`` needs to rebuild it).
        loss: The loss function for training, a callable on tensors.
        optimizer: An ``OptimizerSpec``; AdamW at lr 1e-4 when None.
        metric: The metric for validation (callable; lower is better).
        device: The device to train on, ``"cuda"`` unless asked otherwise.
        lr_scheduler: A ``ReduceLROnPlateau`` or None.
        log_image_interval: Iterations between image logs.
        mixed_precision: Whether to compute in bfloat16 (parameters stay f32).
        early_stopping: Epochs without improvement before stopping.
        logger: The logger class (a ``TorchEmLogger``) or None.
        logger_kwargs: Keyword arguments for the logger class.
        id_: Unique identifier for the trainer; the checkpoint folder's name.
        save_root: Root folder for checkpoints; ``./checkpoints`` when None.
        compile_model: Accepted for API parity; the model runs eagerly.
        rank: Rank for distributed training (only rank 0 writes checkpoints).
        seed: Recorded for API parity; the port's models draw no random
            numbers in a step.
        device_label_transform: A callable applied to the labels inside the step.
        steps_per_execution: Accepted for API parity; steps run one by one.
    """

    def __init__(
        self,
        name: str,
        train_loader=None,
        val_loader=None,
        model: Optional[torch.nn.Module] = None,
        loss=None,
        optimizer: Optional[OptimizerSpec] = None,
        metric=None,
        device: Union[str, torch.device] = "cuda",
        lr_scheduler: Optional[ReduceLROnPlateau] = None,
        log_image_interval: int = 100,
        mixed_precision: bool = True,
        early_stopping: Optional[int] = None,
        logger=None,
        logger_kwargs: Optional[Dict[str, Any]] = None,
        id_: Optional[str] = None,
        save_root: Optional[str] = None,
        compile_model: Optional[Union[bool, str]] = None,
        rank: Optional[int] = None,
        seed: int = 42,
        device_label_transform=None,
        steps_per_execution: int = 1,
    ):
        if name is None:
            raise TypeError("Name cannot be None")
        if optimizer is not None and not isinstance(optimizer, OptimizerSpec):
            raise TypeError(f"optimizer must be an OptimizerSpec or None, got {type(optimizer)}")
        self.name = name
        self.id_ = id_ or name
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.metric = metric
        self.device = resolve_device(device)
        self.lr_scheduler = lr_scheduler
        self.log_image_interval = log_image_interval
        self.save_root = save_root
        self.rank = rank
        self.device_label_transform = device_label_transform
        self.mixed_precision = mixed_precision
        self.early_stopping = early_stopping

        self._iteration = 0
        self._epoch = 0
        self._best_epoch = 0
        self.train_time = 0.0

        self.logger_class = logger
        self.logger_kwargs = logger_kwargs
        self.logger = None
        self.torch_optimizer: Optional[torch.optim.Optimizer] = None

        self._explicit_init_kwargs = {
            "name": name, "train_loader": train_loader, "val_loader": val_loader, "model": model,
            "loss": loss, "optimizer": optimizer, "metric": metric, "device": str(device),
            "lr_scheduler": lr_scheduler, "log_image_interval": log_image_interval,
            "mixed_precision": mixed_precision, "early_stopping": early_stopping,
            "logger": logger, "logger_kwargs": logger_kwargs, "id_": id_, "save_root": save_root,
            "compile_model": compile_model, "seed": seed,
            "device_label_transform": device_label_transform,
            "steps_per_execution": steps_per_execution,
        }

    @property
    def checkpoint_folder(self):
        root = "./checkpoints" if self.save_root is None else os.path.join(self.save_root, "checkpoints")
        return os.path.join(root, self.id_)

    @property
    def iteration(self):
        return self._iteration

    @property
    def epoch(self):
        return self._epoch

    # ------------------------------------------------------------- stepping
    @contextlib.contextmanager
    def _compute_precision(self):
        """bfloat16 compute for the duration of a forward when ``mixed_precision`` is on."""
        if not (self.mixed_precision and hasattr(self.model, "dtype")):
            yield
            return
        dtype = self.model.dtype
        self.model.dtype = torch.bfloat16
        try:
            yield
        finally:
            self.model.dtype = dtype

    def _compute_loss(self, x, y):
        if self.device_label_transform is not None:
            y = self.device_label_transform(y)
        with self._compute_precision():
            pred = self.model(x)
        return self.loss(pred, y), pred

    def _train_step(self, x, y):
        """One optimizer step on a batch on the device; returns the detached loss and prediction."""
        self.torch_optimizer.zero_grad(set_to_none=True)
        loss, pred = self._compute_loss(x, y)
        loss.backward()
        self.optimizer.clip_gradients(self.model.parameters())
        self.torch_optimizer.step()
        return loss.detach(), pred.detach()

    @torch.no_grad()
    def _val_step(self, x, y):
        loss, pred = self._compute_loss(x, y)
        if self.metric is not None and not getattr(self.metric, "host_metric", False):
            yt = y if self.device_label_transform is None else self.device_label_transform(y)
            metric = self.metric(pred, yt)
        else:
            metric = loss
        return loss, metric, pred

    # ----------------------------------------------------------- init & fit
    def _initialize(self, iterations, load_from_checkpoint, epochs=None):
        for what in ("train_loader", "val_loader", "model", "loss", "metric"):
            if getattr(self, what) is None:
                raise ValueError(f"The trainer needs a {what} to fit.")
        if sum((iterations is not None, epochs is not None)) != 1:
            raise ValueError("Exactly one of 'iterations' or 'epochs' has to be specified.")

        if load_from_checkpoint is not None:
            self.load_checkpoint(load_from_checkpoint)

        if iterations is None:
            epochs_ = epochs
            iterations = epochs_ * len(self.train_loader)
        else:
            epochs_ = int(np.ceil(iterations / len(self.train_loader)))
        self.max_iteration = self._iteration + iterations
        self.max_epoch = self._epoch + epochs_

        self._build_optimizer()
        if self.lr_scheduler is not None:
            self.lr_scheduler.attach(self)
        if self.logger is None and self.logger_class is not None:
            self.logger = self.logger_class(self, self.save_root, **(self.logger_kwargs or {}))
        os.makedirs(self.checkpoint_folder, exist_ok=True)
        return np.inf  # the best metric so far

    def _build_optimizer(self):
        """Move the model to the training device and build the optimizer over its parameters."""
        self.model.to(self.device)
        if self.optimizer is None:
            self.optimizer = OptimizerSpec("adamw", lr=1e-4)
        if self.torch_optimizer is None:
            self.torch_optimizer = self.optimizer.build(self.model.parameters())

    # ------------------------------------------------------------- chkpting
    def _checkpoint_path(self, name):
        return os.path.join(self.checkpoint_folder, f"{name}.ckpt")

    def _build_init(self) -> Dict[str, Any]:
        init = {}
        for k, v in self._explicit_init_kwargs.items():
            if k == "logger":
                init[k] = None if v is None else serialize_value(v)
                continue
            try:
                init[k] = serialize_value_or_pickle(v)
            except ValueError as e:
                warnings.warn(f"Could not serialize trainer kwarg {k}: {e}")
                init[k] = None
        return {"trainer_class": f"{type(self).__module__}.{type(self).__qualname__}", "kwargs": init}

    def save_checkpoint(self, name, current_metric, best_metric, train_time=0.0, **extra_save_dict):
        """Write model and optimizer state, bookkeeping and the constructor spec."""
        if self.rank not in (None, 0):
            return
        save_dict = {
            "iteration": self._iteration,
            "epoch": self._epoch,
            "best_epoch": self._best_epoch,
            "best_metric": float(best_metric),
            "current_metric": float(current_metric),
            "train_time": float(train_time),
            "timestamp": datetime.now().strftime("%d-%m-%Y (%H:%M:%S)"),
            "model_state": self.model.state_dict(),
            "optimizer_state": self.torch_optimizer.state_dict(),
            "init": json.dumps(self._build_init()),
        }
        if self.lr_scheduler is not None:
            save_dict["scheduler_state"] = self.lr_scheduler.state_dict()
        save_dict.update(extra_save_dict)
        torch.save(save_dict, self._checkpoint_path(name))

    @staticmethod
    def _load_save_dict(path, map_location="cpu"):
        if os.path.isdir(path):
            raise ValueError(f"Expected a checkpoint file, got directory {path}")
        if not path.endswith(".ckpt") and not os.path.exists(path):
            path = path + ".ckpt"
        return torch.load(path, map_location=map_location, weights_only=True)

    def load_checkpoint(self, checkpoint="best"):
        """Load a checkpoint (``"best"``, ``"latest"`` or a path) into this trainer."""
        if checkpoint in ("best", "latest") or not os.path.exists(str(checkpoint)):
            path = self._checkpoint_path(checkpoint)
        else:
            path = str(checkpoint)
        if not os.path.exists(path):
            raise ValueError(f"Checkpoint {path} does not exist.")
        save_dict = self._load_save_dict(path, map_location=self.device)

        self._iteration = int(save_dict["iteration"])
        self._epoch = int(save_dict["epoch"])
        self._best_epoch = int(save_dict["best_epoch"])
        self.best_metric = float(save_dict["best_metric"])
        self.current_metric = float(save_dict["current_metric"])
        self.train_time = float(save_dict.get("train_time", 0.0))

        self.model.load_state_dict(save_dict["model_state"])
        self.torch_optimizer = None
        self._build_optimizer()
        self.torch_optimizer.load_state_dict(save_dict["optimizer_state"])
        if self.lr_scheduler is not None and "scheduler_state" in save_dict:
            self.lr_scheduler.load_state_dict(save_dict["scheduler_state"])
        return save_dict

    @classmethod
    def from_checkpoint(cls, checkpoint_folder, name="best", device=None):
        """Rebuild a trainer from a checkpoint alone; ``device`` overrides the recorded one
        for the trainer and its model."""
        path = os.path.join(checkpoint_folder, f"{name}.ckpt")
        init = json.loads(cls._load_save_dict(path)["init"])
        trainer_cls = resolve_path(init["trainer_class"])
        specs = init["kwargs"]
        if device is not None:
            specs["device"] = str(device)
            model_spec = specs.get("model")
            if isinstance(model_spec, dict) and "__model__" in model_spec:
                model_spec["kwargs"]["device"] = str(device)
        kwargs = {k: deserialize_value(v) for k, v in specs.items()}
        trainer = trainer_cls(**kwargs)
        # point the trainer at the folder it was loaded from
        if os.path.abspath(trainer.checkpoint_folder) != os.path.abspath(checkpoint_folder):
            trainer.save_root = os.path.dirname(os.path.dirname(os.path.abspath(checkpoint_folder)))
            trainer.id_ = os.path.basename(os.path.abspath(checkpoint_folder))
        trainer.load_checkpoint(path)
        return trainer

    def _verify_if_training_completed(self, checkpoint="latest"):
        ckpt_path = self._checkpoint_path(checkpoint)
        if not os.path.exists(ckpt_path):
            return False
        return int(self._load_save_dict(ckpt_path)["iteration"]) >= self.max_iteration

    # ------------------------------------------------------------- training
    def _to_device(self, batch):
        return torch.as_tensor(batch).to(self.device, non_blocking=True)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _flush(self, buffer):
        """Hand buffered training losses to the logger; reading them waits for the device."""
        for step, loss, lr, images in buffer:
            x, y, pred = images if images is not None else (None, None, None)
            self.logger.log_train(step, float(loss), lr, x, y, pred)
        buffer.clear()

    def _train_epoch(self):
        self.model.train()
        n_iter = 0
        t_start = time.time()
        lr = get_learning_rate(self.torch_optimizer)
        buffer = []
        for x, y in self.train_loader:
            x, y = self._to_device(x), self._to_device(y)
            loss, pred = self._train_step(x, y)
            if self.logger is not None:
                want_images = self._iteration % self.log_image_interval == 0
                buffer.append((self._iteration, loss, lr, (x, y, pred) if want_images else None))
                if len(buffer) >= 50 or want_images:
                    self._flush(buffer)
            self._iteration += 1
            n_iter += 1
            if self._iteration >= self.max_iteration:
                break
        if self.logger is not None:
            self._flush(buffer)
        self._sync()
        return (time.time() - t_start) / max(n_iter, 1)

    def _validate(self):
        self.model.eval()
        metric_list, loss_list = [], []
        last = None
        for x, y in self.val_loader:
            x, y = self._to_device(x), self._to_device(y)
            loss, metric, pred = self._val_step(x, y)
            if self.metric is not None and getattr(self.metric, "host_metric", False):
                metric = self.metric(pred.cpu().numpy(), y.cpu().numpy())
            metric_list.append(metric)
            loss_list.append(loss)
            last = (x, y, pred)
        metric_val = float(np.mean([float(m) for m in metric_list]))
        loss_val = float(np.mean([float(v) for v in loss_list]))
        if self.logger is not None and last is not None:
            self.logger.log_validation(self._iteration, metric_val, loss_val, *last)
        return metric_val

    def fit(
        self,
        iterations: Optional[int] = None,
        load_from_checkpoint: Optional[str] = None,
        epochs: Optional[int] = None,
        save_every_kth_epoch: Optional[int] = None,
        overwrite_training: bool = True,
    ):
        """Run training; exactly one of 'iterations' or 'epochs' must be given."""
        best_metric = self._initialize(iterations, load_from_checkpoint, epochs)

        if not overwrite_training:
            if load_from_checkpoint is not None:
                raise ValueError(
                    "We do not support 'overwrite_training=False' and 'load_from_checkpoint' at the same time."
                )
            if self._verify_if_training_completed():
                print(
                    f"The model is trained for {self.max_iteration} iterations / {self.max_epoch} epochs "
                    "and 'overwrite_training' is set to 'False'."
                )
                return

        print("Start fitting for", self.max_iteration - self._iteration,
              "iterations /", self.max_epoch - self._epoch, "epochs")
        print("with", len(self.train_loader), "iterations per epoch")

        msg = "Epoch %i: average [s/it]: %f, current metric: %f, best metric: %f"
        train_time_start = time.time()
        while self._epoch < self.max_epoch and self._iteration < self.max_iteration:
            self.train_loader.set_epoch(self._epoch)
            t_per_iter = self._train_epoch()
            current_metric = self._validate()
            self.current_metric = current_metric

            if self.lr_scheduler is not None:
                self.lr_scheduler.step(current_metric)

            total_train_time = (time.time() - train_time_start) + self.train_time
            if current_metric < best_metric:
                best_metric = current_metric
                self._best_epoch = self._epoch
                self.save_checkpoint("best", current_metric, best_metric, train_time=total_train_time)

            self.save_checkpoint("latest", current_metric, best_metric, train_time=total_train_time)
            if save_every_kth_epoch is not None and (self._epoch + 1) % save_every_kth_epoch == 0:
                self.save_checkpoint(
                    f"epoch-{self._epoch + 1}", current_metric, best_metric, train_time=total_train_time
                )

            if self.early_stopping is not None:
                epochs_since_best = self._epoch - self._best_epoch
                if epochs_since_best > self.early_stopping:
                    print("Stopping training because there has been no improvement for",
                          self.early_stopping, "epochs")
                    break

            self._epoch += 1
            print(msg % (self._epoch, t_per_iter, current_metric, best_metric), flush=True)

        print(f"Finished training after {self._epoch} epochs / {self._iteration} iterations.")
        print(f"The best epoch is number {self._best_epoch}.")
