"""Shallow2Deep: random forests on filter-bank features, enhanced by a U-Net (arXiv:2201.05846).

The port's own copy of ``torch_em_tpu/shallow2deep/``, with ``forest.py``,
which fits a forest natively as sklearn fits it, keeps it as arrays and
predicts with it in numpy, and ``sklearn_pickle.py``, which reads and writes
sklearn's pickled forests, so that no path needs sklearn.
"""

from .forest import (
    Forest, fit_forest, forest_from_sklearn, forest_to_sklearn, load_forest, node_differences, save_forest,
    save_forest_pickle,
)
from .prepare_shallow2deep import export_forests, prepare_shallow2deep, prepare_shallow2deep_advanced
from .pseudolabel_training import get_pseudolabel_dataset, get_pseudolabel_loader
from .shallow2deep_dataset import (
    Shallow2DeepDataset, Shallow2DeepImageCollectionDataset, get_shallow2deep_dataset, get_shallow2deep_loader,
)
from .shallow2deep_eval import evaluate_enhancers, visualize_pretrained_rfs
from .shallow2deep_model import IlastikPredicter, RFWithFilters, Shallow2DeepModel
from .transform import BoundaryTransform, ForegroundTransform

__all__ = [
    "Forest", "fit_forest", "forest_from_sklearn", "forest_to_sklearn", "load_forest", "node_differences",
    "save_forest", "save_forest_pickle", "export_forests", "prepare_shallow2deep",
    "prepare_shallow2deep_advanced", "get_pseudolabel_dataset", "get_pseudolabel_loader", "Shallow2DeepDataset",
    "Shallow2DeepImageCollectionDataset", "get_shallow2deep_dataset", "get_shallow2deep_loader",
    "evaluate_enhancers", "visualize_pretrained_rfs", "IlastikPredicter", "RFWithFilters", "Shallow2DeepModel",
    "BoundaryTransform", "ForegroundTransform",
]
