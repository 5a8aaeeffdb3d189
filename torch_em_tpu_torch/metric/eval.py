"""Instance-segmentation evaluation measures.

Numpy rebuilds of the elf.evaluation functions the reference metrics use
(torch_em/metric/instance_segmentation_metric.py:173-211): IoU-based
``matching`` (stardist-style precision/recall/f1 via Hungarian matching),
``variation_of_information``, ``rand_index`` (adapted Rand error), and
``symmetric_best_dice_score``. The port's copy of the JAX package's
``metric/eval.py``: float64 numpy on the host.
"""

from typing import Tuple

import numpy as np
from scipy import sparse
from scipy.optimize import linear_sum_assignment

__all__ = ["contingency_table", "matching", "variation_of_information", "rand_index",
           "symmetric_best_dice_score"]


def contingency_table(seg_a: np.ndarray, seg_b: np.ndarray):
    """Sparse contingency matrix of two label images (counts of label pairs)."""
    a = np.asarray(seg_a).ravel().astype("int64")
    b = np.asarray(seg_b).ravel().astype("int64")
    assert a.shape == b.shape
    table = sparse.coo_matrix((np.ones(a.size, dtype="float64"), (a, b))).tocsr()
    return table


def matching(
    seg: np.ndarray, gt: np.ndarray, threshold: float = 0.5, criterion: str = "iou",
) -> dict:
    """IoU matching of predicted and GT instances (stardist-style).

    Returns a dict with precision, recall, f1, accuracy, tp, fp, fn counts.
    Background (label 0) is excluded on both sides.
    """
    assert criterion == "iou"
    table = contingency_table(seg, gt).toarray()
    # drop background row/col; empty slices are fine (a background-only side
    # yields a (0, n) / (n, 0) overlap consistent with the size vectors)
    overlap = table[1:, 1:]
    seg_sizes = table.sum(axis=1)[1:]
    gt_sizes = table.sum(axis=0)[1:]
    # remove empty labels
    pred_nonzero = seg_sizes > 0
    true_nonzero = gt_sizes > 0
    overlap = overlap[pred_nonzero][:, true_nonzero]
    seg_sizes = seg_sizes[pred_nonzero]
    gt_sizes = gt_sizes[true_nonzero]
    n_pred, n_true = len(seg_sizes), len(gt_sizes)

    if n_pred == 0 or n_true == 0:
        tp = 0
    else:
        union = seg_sizes[:, None] + gt_sizes[None, :] - overlap
        iou = np.where(union > 0, overlap / np.maximum(union, 1e-10), 0.0)
        # optimal 1:1 matching maximizing total IoU among pairs above threshold
        cost = -(iou * (iou >= threshold))
        row, col = linear_sum_assignment(cost)
        tp = int(np.sum(iou[row, col] >= threshold))

    fp = n_pred - tp
    fn = n_true - tp
    precision = tp / n_pred if n_pred > 0 else 0.0
    recall = tp / n_true if n_true > 0 else 0.0
    f1 = (2 * tp / (n_pred + n_true)) if (n_pred + n_true) > 0 else 0.0
    accuracy = tp / (tp + fp + fn) if (tp + fp + fn) > 0 else 0.0
    return {
        "precision": precision, "recall": recall, "f1": f1, "accuracy": accuracy,
        "tp": tp, "fp": fp, "fn": fn, "n_pred": n_pred, "n_true": n_true,
    }


def variation_of_information(
    seg: np.ndarray, gt: np.ndarray, ignore_seg=None, ignore_gt=None,
) -> Tuple[float, float]:
    """Variation of information, returned as (splits, merges) like elf.

    vi_split = H(seg | gt), vi_merge = H(gt | seg).
    """
    a = np.asarray(gt).ravel().astype("int64")
    b = np.asarray(seg).ravel().astype("int64")
    keep = np.ones(a.shape, dtype=bool)
    if ignore_gt is not None:
        keep &= ~np.isin(a, ignore_gt)
    if ignore_seg is not None:
        keep &= ~np.isin(b, ignore_seg)
    a, b = a[keep], b[keep]
    n = a.size
    if n == 0:
        return 0.0, 0.0
    table = sparse.coo_matrix((np.ones(n, dtype="float64"), (a, b))).tocsr()
    pxy = table.data / n
    px = np.asarray(table.sum(axis=1)).ravel() / n
    py = np.asarray(table.sum(axis=0)).ravel() / n
    coo = table.tocoo()
    hxgy = -np.sum(pxy * (np.log(pxy) - np.log(py[coo.col])))  # H(gt | seg) = merges
    hygx = -np.sum(pxy * (np.log(pxy) - np.log(px[coo.row])))  # H(seg | gt) = splits
    return float(hygx), float(hxgy)


def rand_index(seg: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """(adapted Rand error, Rand index) — elf.evaluation.rand_index parity.

    Adapted Rand error = 1 - F-score of the pair-counting precision/recall
    (SNEMI convention, gt label 0 treated as background and ignored).
    """
    a = np.asarray(gt).ravel().astype("int64")
    b = np.asarray(seg).ravel().astype("int64")
    keep = a != 0
    a, b = a[keep], b[keep]
    n = a.size
    if n == 0:
        return 0.0, 1.0
    table = sparse.coo_matrix((np.ones(n, dtype="float64"), (a, b))).tocsr()
    sum_pij2 = float((table.data ** 2).sum())
    ai = np.asarray(table.sum(axis=1)).ravel()
    bj = np.asarray(table.sum(axis=0)).ravel()
    sum_ai2 = float((ai ** 2).sum())
    sum_bj2 = float((bj ** 2).sum())
    precision = sum_pij2 / sum_bj2
    recall = sum_pij2 / sum_ai2
    f_score = 2 * precision * recall / max(precision + recall, 1e-10)
    are = 1.0 - f_score
    # plain rand index over pairs
    n_pairs = n * (n - 1) / 2
    same_both = (sum_pij2 - n) / 2
    same_a = (sum_ai2 - n) / 2
    same_b = (sum_bj2 - n) / 2
    ri = float(1.0 - (same_a + same_b - 2 * same_both) / max(n_pairs, 1)) if n_pairs > 0 else 1.0
    return float(are), ri


def symmetric_best_dice_score(seg: np.ndarray, gt: np.ndarray) -> float:
    """Symmetric best dice: min(BD(seg, gt), BD(gt, seg)) (CVPPP convention)."""
    table = contingency_table(seg, gt).toarray()
    overlap = table[1:, 1:]
    seg_sizes = table.sum(axis=1)[1:]
    gt_sizes = table.sum(axis=0)[1:]
    seg_nonzero = seg_sizes > 0
    gt_nonzero = gt_sizes > 0
    overlap = overlap[seg_nonzero][:, gt_nonzero]
    seg_sizes = seg_sizes[seg_nonzero]
    gt_sizes = gt_sizes[gt_nonzero]
    if overlap.size == 0:
        return 0.0
    dice = 2 * overlap / (seg_sizes[:, None] + gt_sizes[None, :])
    bd_seg = float(dice.max(axis=1).mean())  # best dice per seg object
    bd_gt = float(dice.max(axis=0).mean())   # best dice per gt object
    return min(bd_seg, bd_gt)
