"""Checkpoint validation (reference torch_em/util/validation.py).

The port's counterpart of the JAX package's ``utils/validation.py``.
``validate_checkpoint`` (:194) rebuilds the trainer from a checkpoint, runs
``predict_with_halo`` over validation samples, optionally computes metrics
and saves predictions; ``SampleGenerator`` (:20) yields (raw, gt) pairs from
the paths of the trainer's validation data. Prediction runs on the card
unless ``gpu_ids`` names the CPU (``("cpu",)``), on as many devices as it
names. napari, which shows a sample
beside its prediction, is imported only when ``visualize`` asks for it.
"""

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .io import load_data, write_data
from .prediction import _as_device, predict_with_halo
from .util import get_normalizer, get_trainer

__all__ = ["SampleGenerator", "validate_checkpoint", "main"]


class SampleGenerator:
    """Yields (raw, ground-truth) validation samples from data paths
    (reference validation.py:20)."""

    def __init__(self, trainer, max_samples: Optional[int] = None, need_gt: bool = True,
                 n_threads: Optional[int] = None):
        self.need_gt = need_gt
        dataset = trainer.val_loader.dataset
        datasets = dataset.datasets if hasattr(dataset, "datasets") else [dataset]
        self.raw_data = []
        self.gt_data = []
        for ds in datasets:
            if hasattr(ds, "raw_path"):
                self.raw_data.append((ds.raw_path, ds.raw_key))
                self.gt_data.append((ds.label_path, ds.label_key))
            elif hasattr(ds, "raw_images"):
                for rp, lp in zip(ds.raw_images, ds.label_images):
                    self.raw_data.append((rp, None))
                    self.gt_data.append((lp, None))
        if max_samples is not None:
            self.raw_data = self.raw_data[:max_samples]
            self.gt_data = self.gt_data[:max_samples]

    def __len__(self):
        return len(self.raw_data)

    def __iter__(self):
        for (rp, rk), (lp, lk) in zip(self.raw_data, self.gt_data):
            raw = np.asarray(load_data(rp, rk)[:])
            if self.need_gt:
                gt = np.asarray(load_data(lp, lk)[:])
                yield raw, gt
            else:
                yield raw


def _predict(model, raw, trainer, gpu_ids, save_path, sample_id, block_shape=None, halo=None):
    """Halo prediction of one sample (reference validation.py:143)."""
    normalizer = get_normalizer(trainer)
    ndim = trainer.train_loader.dataset.ndim
    if block_shape is None:
        block_shape = (64,) * ndim if ndim == 3 else (256, 256)
    if halo is None:
        halo = (8,) * ndim if ndim == 3 else (32, 32)
    if ndim == 2 and raw.ndim == 3:
        # 2d model over a 3d stack: predict per z-slice
        slices = [
            predict_with_halo(raw[z], model, gpu_ids=gpu_ids, block_shape=block_shape,
                              halo=halo, preprocess=normalizer, disable_tqdm=True)
            for z in range(raw.shape[0])
        ]
        prediction = np.stack(slices, axis=1)
    else:
        prediction = predict_with_halo(
            raw, model, gpu_ids=gpu_ids, block_shape=block_shape, halo=halo,
            preprocess=normalizer, disable_tqdm=True,
        )
    if save_path is not None:
        write_data(save_path, f"predictions/sample{sample_id}", prediction)
    return prediction


def validate_checkpoint(
    checkpoint: str,
    gpu_ids: Sequence[Union[str, int]] = ("cuda",),
    save_path: Optional[str] = None,
    samples: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
    max_samples: Optional[int] = None,
    visualize: bool = True,
    metrics: Optional[Callable] = None,
    n_threads: Optional[int] = None,
    block_shape=None,
    halo=None,
) -> List:
    """Validate a checkpoint by predicting its validation data
    (reference validation.py:194).

    The trainer and its model are rebuilt on the first device ``gpu_ids``
    names (the card by default; ``("cpu",)`` for the CPU); with several,
    ``predict_with_halo`` predicts through a replica on each. ``metrics(gt,
    prediction)`` scores each sample; without it the predictions are
    returned.
    """
    trainer = get_trainer(checkpoint, device=_as_device(gpu_ids[0]))
    model = trainer.model
    need_gt = metrics is not None
    if samples is None:
        samples = SampleGenerator(trainer, max_samples, need_gt)

    results = []
    for sample_id, sample in enumerate(samples):
        raw, gt = sample if need_gt else (sample if isinstance(sample, np.ndarray) else sample[0], None)
        prediction = _predict(model, raw, trainer, gpu_ids, save_path, sample_id,
                              block_shape=block_shape, halo=halo)
        if visualize:
            _visualize(raw, prediction, gt)
        if metrics is not None:
            results.append(metrics(gt, prediction))
        else:
            results.append(prediction)
    return results


def _visualize(raw, prediction, ground_truth):
    """Show a sample, its prediction and its ground truth in napari."""
    try:
        import napari
    except ImportError as e:
        raise ImportError("visualize=True needs napari, which is not installed; pass "
                          "visualize=False") from e

    viewer = napari.Viewer()
    viewer.add_image(raw)
    viewer.add_image(prediction)
    if ground_truth is not None:
        viewer.add_labels(ground_truth)
    napari.run()


def main():
    """CLI: torch_em.validate_checkpoint (reference validation.py:249); predicts on the
    card unless ``-g cpu``."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("-p", "--path", required=True, help="Path to the checkpoint")
    parser.add_argument("-g", "--gpus", type=str, nargs="+", default=["cuda"])
    parser.add_argument("-s", "--save_path", default=None)
    parser.add_argument("-m", "--max_samples", type=int, default=None)
    args = parser.parse_args()
    validate_checkpoint(args.path, args.gpus, args.save_path, max_samples=args.max_samples,
                        visualize=False)
