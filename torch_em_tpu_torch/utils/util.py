"""Checkpoint and model helpers.

The port's own copy of ``torch_em_tpu/utils/util.py`` (after torch-em's
``util/util.py``): ``get_trainer`` rebuilds a trainer with
``DefaultTrainer.from_checkpoint``, ``load_model`` its model or loads a
checkpoint's weights into a given one, ``get_normalizer`` finds the raw
normalizer of the training data, ``model_is_equal`` compares parameters,
``get_constructor_arguments`` reads the ``init_kwargs`` convention, and
``get_random_colors`` builds a matplotlib colormap for a label image.
``is_compiled`` says whether a model is ``torch.compile``'s wrapper;
``auto_compile`` returns the model as it is, since the trainer runs eagerly.
"""

import os
from typing import Optional, Union

import numpy as np
import torch

__all__ = [
    "get_trainer", "get_normalizer", "load_model", "model_is_equal", "get_constructor_arguments",
    "get_random_colors", "is_compiled", "auto_compile",
]


def is_compiled(model) -> bool:
    """Whether ``model`` is the wrapper that ``torch.compile`` returns."""
    return isinstance(model, torch._dynamo.eval_frame.OptimizedModule)


def auto_compile(model, compile_model=None, default_compile: bool = True):
    """The model as it is: the port's trainer runs models eagerly and takes
    ``compile_model`` for the signature's sake, as this does."""
    return model


def get_constructor_arguments(obj) -> dict:
    """The constructor arguments of a package object, which every class keeps in
    ``init_kwargs``."""
    return dict(obj.init_kwargs) if hasattr(obj, "init_kwargs") else {}


def get_trainer(checkpoint, name: str = "best", device: Optional[Union[str, torch.device]] = None):
    """A trainer rebuilt from a checkpoint folder (``DefaultTrainer.from_checkpoint``); a
    trainer passes through. ``device`` None keeps the device the checkpoint records."""
    from ..trainer import DefaultTrainer

    if isinstance(checkpoint, DefaultTrainer):
        return checkpoint
    if not os.path.exists(checkpoint):
        raise ValueError(f"Could not find the checkpoint folder {checkpoint}")
    return DefaultTrainer.from_checkpoint(checkpoint, name=name, device=device)


def get_normalizer(trainer):
    """The raw normalizer of the trainer's training data (``standardize`` if it has none)."""
    dataset = trainer.train_loader.dataset
    while hasattr(dataset, "datasets"):
        dataset = dataset.datasets[0]
    preprocessor = getattr(dataset, "raw_transform", None)
    if preprocessor is None:
        from ..transforms.raw import standardize

        return standardize
    if hasattr(preprocessor, "normalizer"):
        return preprocessor.normalizer
    return preprocessor


def load_model(checkpoint, model=None, name: str = "best", state_key: str = "model_state",
               device: Optional[Union[str, torch.device]] = None):
    """The model of a checkpoint: rebuilt with its trainer, or, when ``model`` is given,
    that model with the checkpoint's ``state_key`` weights loaded."""
    if model is None:
        return get_trainer(checkpoint, name=name, device=device).model
    from ..trainer import DefaultTrainer

    save_dict = DefaultTrainer._load_save_dict(os.path.join(checkpoint, f"{name}.ckpt"))
    model.load_state_dict(save_dict[state_key])
    return model if device is None else model.to(device)


def model_is_equal(model1, model2) -> bool:
    """Whether two models have the same parameter names, shapes and values."""
    state1, state2 = model1.state_dict(), model2.state_dict()
    if state1.keys() != state2.keys():
        return False
    return all(state1[k].shape == state2[k].shape
               and torch.allclose(state1[k].cpu().float(), state2[k].cpu().float()) for k in state1)


def get_random_colors(labels: np.ndarray):
    """A random matplotlib colormap for a label image, background black."""
    from matplotlib import colors

    n_labels = len(np.unique(labels)) - 1
    cmap = [[0, 0, 0]] + np.random.rand(n_labels, 3).tolist()
    return colors.ListedColormap(cmap)
