"""Shallow2Deep evaluation.

The port's own copy of ``torch_em_tpu/shallow2deep/shallow2deep_eval.py``
(after torch-em's ``shallow2deep/shallow2deep_eval.py``):
``visualize_pretrained_rfs`` predicts an image with a subset of the
ensemble; ``evaluate_enhancers`` scores enhancers on the predictions of
each forest against ground truth. A folder's forests are its ``.npz`` files
where it has any, else its ``.pkl`` files (read without sklearn). pandas is
imported inside ``evaluate_enhancers``; the enhancers run on ``device``.
"""

import os
from typing import Callable, Dict, Optional

import numpy as np

from .forest import forest_paths, load_forest
from .prepare_shallow2deep import _apply_filters, _get_filters

__all__ = ["visualize_pretrained_rfs", "evaluate_enhancers"]


def visualize_pretrained_rfs(checkpoint: str, raw: np.ndarray, n_forests: int, sample_random: bool = False,
                             filter_config=None, n_threads: Optional[int] = None) -> Dict[str, np.ndarray]:
    """{forest file name: prediction (*raw.shape, n_classes)} of ``n_forests`` forests of the
    folder ``checkpoint``, evenly spaced or, with ``sample_random``, drawn at random."""
    rf_paths = forest_paths(checkpoint)
    assert rf_paths, f"No random forests found in {checkpoint}"
    if sample_random:
        rf_paths = list(np.random.choice(rf_paths, size=n_forests, replace=False))
    else:
        rf_paths = rf_paths[:: max(len(rf_paths) // n_forests, 1)][:n_forests]

    features = _apply_filters(raw.astype("float32"), _get_filters(raw.ndim, filter_config))
    predictions = {}
    for path in rf_paths:
        pred = load_forest(path).predict_proba(features)
        predictions[os.path.basename(path)] = pred.reshape(raw.shape + (pred.shape[1],))
    return predictions


def evaluate_enhancers(data: np.ndarray, labels: np.ndarray, enhancers: Dict[str, str], rf_folder: str,
                       metric: Callable, is2d: bool = False, rf_channel=1, filter_config=None,
                       prediction_function=None, device="cuda"):
    """A pandas DataFrame of ``metric(labels, prediction)``: a row per forest of ``rf_folder``,
    a column per enhancer (checkpoint or bioimage.io package) and one for the forest itself."""
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError("evaluate_enhancers returns a pandas DataFrame and needs pandas, which is not "
                          "installed") from e

    from .shallow2deep_model import RFWithFilters, Shallow2DeepModel

    rf_paths = forest_paths(rf_folder)
    assert rf_paths, f"No random forests found in {rf_folder}"
    ndim = 2 if is2d else data.ndim
    models = {name: Shallow2DeepModel.load_model(checkpoint, device=device)
              for name, checkpoint in enhancers.items()}

    scores = {name: [] for name in enhancers}
    scores["rf-score"] = []
    rf_names = []
    for rf_path in rf_paths:
        rf_names.append(os.path.basename(rf_path))
        rf = RFWithFilters(rf_path, ndim, filter_config, output_channel=rf_channel)
        rf_pred = np.stack([rf(sl) for sl in data]) if is2d and data.ndim == 3 else rf(data)
        scores["rf-score"].append(metric(labels, rf_pred))

        for name, model in models.items():
            inp = rf_pred[None, None] if rf_pred.ndim == data.ndim else rf_pred[None]
            if prediction_function is not None:
                pred = np.asarray(prediction_function(model, inp.astype("float32")))[0]
            else:
                import torch

                with torch.inference_mode():
                    pred = model(torch.from_numpy(inp.astype("float32")).to(device)).float().cpu().numpy()[0]
            scores[name].append(metric(labels, pred))

    return pd.DataFrame(scores, index=rf_names)
