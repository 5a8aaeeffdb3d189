"""Shallow2Deep inference: a forest's prediction, enhanced by a network.

The port's own copy of ``torch_em_tpu/shallow2deep/shallow2deep_model.py``
(after torch-em's ``shallow2deep/shallow2deep_model.py``):

- ``RFWithFilters`` predicts with a forest (``.pkl`` or ``.npz``) on the
  filter-bank features of an image, on the host;
- ``IlastikPredicter`` predicts with an ilastik pixel-classification
  project; it needs ilastik, which it imports when built;
- ``Shallow2DeepModel`` runs the forest (or the ilastik project) on each
  sample on the host, then the enhancer on the whole batch on ``device``.
  The enhancer loads from a trainer's checkpoint folder or from a
  bioimage.io package (a folder with ``rdf.yaml``, the ``rdf.yaml`` itself or
  a ``.zip``; ``utils.modelzoo.import_bioimageio_model``).
"""

import os
from typing import Tuple

import numpy as np
import torch

from ..models.base import resolve_device
from .forest import load_forest
from .prepare_shallow2deep import _apply_filters, _get_filters

__all__ = ["RFWithFilters", "IlastikPredicter", "Shallow2DeepModel"]


class RFWithFilters:
    """A random forest's prediction on the filter-bank features of an image."""

    def __init__(self, rf_path: str, ndim: int, filter_config, output_channel=None):
        self.rf = load_forest(rf_path)
        self.filters_and_sigmas = _get_filters(ndim, filter_config)
        self.output_channel = output_channel

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        features = _apply_filters(x.astype("float32"), self.filters_and_sigmas)
        assert features.shape[1] == self.rf.n_features_in_, f"{features.shape[1]}, {self.rf.n_features_in_}"
        out = self.rf.predict_proba(features)
        if self.output_channel is None:
            out_shape = (out.shape[1],) + x.shape
        else:
            out = out[:, self.output_channel]
            out_shape = x.shape if isinstance(self.output_channel, int) else (len(self.output_channel),) + x.shape
        return out.reshape(out_shape).astype("float32")


class IlastikPredicter:
    """The prediction of an ilastik pixel-classification project; needs ilastik's API."""

    def __init__(self, ilp_path: str, ndim: int, ilastik_multi_thread: bool = False, output_channel=None):
        try:
            import ilastik.experimental.api as ilastik_api
            import xarray
        except ImportError as e:
            raise ImportError("IlastikPredicter needs ilastik (ilastik.experimental.api) and xarray, which are "
                              "not installed") from e
        self.ilp = ilastik_api.from_project_file(ilp_path)
        self.dims = ("y", "x") if ndim == 2 else ("z", "y", "x")
        self.output_channel = output_channel
        self._xarray = xarray

    def __call__(self, x: np.ndarray) -> np.ndarray:
        assert x.ndim == len(self.dims), f"{x.ndim}, {self.dims}"
        out = self.ilp.predict(self._xarray.DataArray(x, dims=self.dims)).values
        if self.output_channel is not None:
            out = out[..., self.output_channel]
        return out


def _is_package(checkpoint) -> bool:
    path = str(checkpoint)
    if path.endswith((".zip", ".yaml")):
        return True
    return any(os.path.exists(os.path.join(path, name)) for name in ("rdf.yaml", "bioimageio.yaml"))


class Shallow2DeepModel:
    """The forest's prediction of each sample (on the host), then the enhancer on the batch
    (on ``device``); a numpy float32 (N, C, *spatial) array comes out."""

    @staticmethod
    def load_model(checkpoint, device="cuda"):
        """The enhancer, on ``device``, in eval mode: the model of a trainer's checkpoint
        folder (its ``best`` checkpoint) or of a bioimage.io package."""
        if _is_package(checkpoint):
            from ..utils.modelzoo import import_bioimageio_model

            model, _ = import_bioimageio_model(checkpoint, device=device)
        else:
            from ..utils.util import get_trainer

            model = get_trainer(checkpoint, device=device).model
        return model.eval()

    @staticmethod
    def load_rf(rf_config, rf_channel=1, ilastik_multi_thread=False):
        if len(rf_config) == 3:  # a forest and its filter config
            rf_path, ndim, filter_config = rf_config
            assert isinstance(rf_path, str)
            return RFWithFilters(rf_path, ndim, filter_config, output_channel=rf_channel)
        if len(rf_config) == 2:  # an ilastik project and its dimensionality
            ilp_path, ndim = rf_config
            return IlastikPredicter(ilp_path, ndim, ilastik_multi_thread, output_channel=rf_channel)
        raise ValueError(f"Invalid rf config: {rf_config}")

    def __init__(self, checkpoint: str, rf_config: Tuple, device="cuda", rf_channel: int = 1,
                 ilastik_multi_thread: bool = False):
        self.device = str(resolve_device(device))
        self.model = self.load_model(checkpoint, self.device)
        self.rf_predicter = self.load_rf(rf_config, rf_channel, ilastik_multi_thread)
        self.checkpoint = checkpoint
        self.rf_config = rf_config
        self.rf_channel = rf_channel
        self.ilastik_multi_thread = ilastik_multi_thread

    def rf_prediction(self, x) -> np.ndarray:
        """The forest's prediction of each sample of a (N, C, *spatial) batch (its first channel),
        with a channel axis."""
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        rf_pred = np.stack([self.rf_predicter(sample[0].astype("float32")) for sample in x])
        if rf_pred.ndim == x.ndim - 1:
            rf_pred = rf_pred[:, None]
        return rf_pred

    def enhance(self, rf_pred: np.ndarray) -> np.ndarray:
        """The enhancer's output on a batch of forest predictions, on ``device``."""
        with torch.inference_mode():
            out = self.model(torch.from_numpy(np.ascontiguousarray(rf_pred, dtype=np.float32)).to(self.device))
        return out.float().cpu().numpy()

    def __call__(self, x) -> np.ndarray:
        """x: a (N, C, *spatial) batch (numpy or a tensor); the forest runs per sample on the
        host, the enhancer on the batch on the device."""
        return self.enhance(self.rf_prediction(x))

    # pickled without the forest and the model, which are loaded again
    def __getstate__(self):
        state = self.__dict__.copy()
        del state["rf_predicter"]
        del state["model"]
        return state

    def __setstate__(self, state):
        state["model"] = self.load_model(state["checkpoint"], state["device"])
        state["rf_predicter"] = self.load_rf(state["rf_config"], state["rf_channel"], state["ilastik_multi_thread"])
        self.__dict__.update(state)
