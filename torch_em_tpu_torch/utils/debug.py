"""Viewers of a loader's samples and a trainer's predictions.

The port's own copy of ``torch_em_tpu/utils/debug.py`` (after torch-em's
``util/debug.py``): ``check_loader`` and ``check_trainer`` draw samples (and a
trainer's predictions, computed on its device) with matplotlib, which they
import when called and which raises an ``ImportError`` naming it where it is
missing; without ``save_path`` the figures are closed unsaved. They take
``plt`` for the signature's sake: as in the JAX package, they always draw
with matplotlib.
"""

from typing import Optional

import numpy as np
import torch

__all__ = ["check_loader", "check_trainer"]


def _to_2d(im):
    im = np.asarray(im)
    while im.ndim > 2:
        im = im[im.shape[0] // 2]
    return im


def _numpy(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _samples(loader, n_samples, model=None, device=None):
    for ii, sample in enumerate(loader):
        if ii >= n_samples:
            break
        x, y = sample if isinstance(sample, (tuple, list)) else (sample, None)
        pred = None
        if model is not None:
            with torch.no_grad():
                pred = model(torch.as_tensor(_numpy(x)).to(device))
        yield ii, _numpy(x), None if y is None else _numpy(y), None if pred is None else _numpy(pred)


def _check_plt(loader, n_samples, instance_labels, model=None, device=None, save_path=None):
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("check_loader and check_trainer draw with matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img_size = 5
    fig_paths = []
    for ii, x, y, pred in _samples(loader, n_samples, model, device):
        n_cols = 2 + int(y is not None) + int(pred is not None)
        fig, ax = plt.subplots(1, n_cols, figsize=(n_cols * img_size, img_size))
        ax[0].set_title("raw")
        ax[0].imshow(_to_2d(x[0]), cmap="gray")
        col = 1
        if y is not None:
            target = _to_2d(y[0])
            ax[col].set_title("target")
            if instance_labels:
                from .util import get_random_colors

                ax[col].imshow(target, cmap=get_random_colors(target), interpolation="nearest")
            else:
                ax[col].imshow(target)
            col += 1
        if pred is not None:
            ax[col].set_title("prediction")
            ax[col].imshow(_to_2d(pred[0]))
            col += 1
        ax[-1].set_title("histogram")
        ax[-1].hist(x.ravel(), bins=32)
        if save_path is not None:
            fig_paths.append(f"{save_path}_sample{ii}.png")
            fig.savefig(fig_paths[-1])
        plt.close(fig)
    return fig_paths


def check_trainer(trainer, n_samples: int = 4, instance_labels: bool = False, split: str = "val",
                  loader: Optional[object] = None, plt: bool = True, save_path: Optional[str] = None):
    """Draw ``n_samples`` batches of the trainer's ``split`` loader (or ``loader``) with the
    model's predictions; returns the paths of the saved figures."""
    if loader is None:
        loader = trainer.val_loader if split == "val" else trainer.train_loader
    return _check_plt(loader, n_samples, instance_labels, model=trainer.model.eval(), device=trainer.device,
                      save_path=save_path)


def check_loader(loader, n_samples: int = 4, instance_labels: bool = False, plt: bool = True,
                 save_path: Optional[str] = None):
    """Draw ``n_samples`` batches of a loader; returns the paths of the saved figures."""
    return _check_plt(loader, n_samples, instance_labels, save_path=save_path)
