"""The ``sklearn.metrics`` scores of two label vectors, in numpy.

The machine with the card has no scikit-learn, so ``ClassificationMetric``
computes these scores itself, as sklearn 1.9 computes them
(``sklearn/metrics/_classification.py``) for binary and multiclass label
vectors: ``accuracy_score``, ``balanced_accuracy_score``,
``precision_score``, ``recall_score``, ``f1_score``, ``fbeta_score``,
``jaccard_score``, ``matthews_corrcoef``, ``cohen_kappa_score``,
``hamming_loss`` and ``zero_one_loss``, with sklearn's keyword arguments
(``average``: ``"binary"``, ``"micro"``, ``"macro"``, ``"weighted"`` or
None; ``labels``, ``pos_label``, ``sample_weight``, ``zero_division``, whose
``"warn"`` gives 0.0 with an ``UndefinedMetricWarning``-like warning;
``normalize``, ``adjusted``, ``beta`` and ``weights`` where sklearn has them).
Multilabel indicator targets and ``average="samples"`` are sklearn's alone.
"""

import warnings

import numpy as np

__all__ = ["accuracy_score", "balanced_accuracy_score", "precision_score", "recall_score", "f1_score",
           "fbeta_score", "jaccard_score", "matthews_corrcoef", "cohen_kappa_score", "hamming_loss",
           "zero_one_loss", "SCORES"]

AVERAGES = (None, "micro", "macro", "weighted")


def _column(y, name):
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y.ravel()
    if y.ndim != 1:
        raise ValueError(f"{name} must be a vector of labels, got shape {y.shape}")
    if y.dtype.kind == "f" and not np.array_equal(y, np.round(y)):
        raise ValueError(f"{name} holds continuous values; the scores take class labels")
    return y


def _targets(y_true, y_pred, sample_weight=None):
    """The label vectors, their sorted labels, whether they are binary, and the weights (or None)."""
    y_true, y_pred = _column(y_true, "y_true"), _column(y_pred, "y_pred")
    if len(y_true) != len(y_pred) or len(y_true) < 1:
        raise ValueError(f"label vectors of {len(y_true)} and {len(y_pred)} samples")
    if sample_weight is not None:
        sample_weight = np.asarray(sample_weight)
        if sample_weight.shape != y_true.shape:
            raise ValueError(f"sample_weight of shape {sample_weight.shape} for {len(y_true)} samples")
    present = np.union1d(y_true, y_pred)
    return y_true, y_pred, present, len(present) <= 2, sample_weight


def _average(a, weights=None, normalize=True):
    """sklearn's ``utils/_array_api.py:_average`` for numpy."""
    if normalize:
        return np.average(a, weights=weights)
    if weights is not None:
        return np.dot(a, weights)
    return np.sum(np.asarray(a, dtype=np.float64))


def accuracy_score(y_true, y_pred, normalize: bool = True, sample_weight=None) -> float:
    """The (weighted) share of equal labels, or with ``normalize=False`` their (weighted) count."""
    y_true, y_pred, _, _, sample_weight = _targets(y_true, y_pred, sample_weight)
    return float(_average(y_true == y_pred, weights=sample_weight, normalize=normalize))


def zero_one_loss(y_true, y_pred, normalize: bool = True, sample_weight=None) -> float:
    """1 - accuracy, or with ``normalize=False`` the (weighted) count of unequal labels."""
    score = accuracy_score(y_true, y_pred, normalize=normalize, sample_weight=sample_weight)
    if normalize:
        return 1 - score
    n_samples = np.sum(sample_weight) if sample_weight is not None else len(np.asarray(y_true))
    return n_samples - score


def hamming_loss(y_true, y_pred, sample_weight=None) -> float:
    """The (weighted) share of unequal labels."""
    y_true, y_pred, _, _, sample_weight = _targets(y_true, y_pred, sample_weight)
    return float(_average(y_true != y_pred, weights=sample_weight, normalize=True))


def confusion_matrix(y_true, y_pred, labels=None, sample_weight=None) -> np.ndarray:
    """sklearn's ``confusion_matrix`` (rows true, columns predicted) of label vectors: int64 counts,
    or float64 sums of float weights; samples with a label outside ``labels`` are left out."""
    y_true, y_pred, present, _, sample_weight = _targets(y_true, y_pred, sample_weight)
    if labels is None:
        labels = present
    else:
        labels = np.asarray(labels)
        if labels.size == 0:
            raise ValueError("'labels' should contain at least one label.")
        if len(np.intersect1d(y_true, labels)) == 0:
            raise ValueError("At least one label specified must be in y_true")
    n_labels = labels.size
    index = {label: i for i, label in enumerate(labels.tolist())}
    rows = np.array([index.get(label, n_labels + 1) for label in y_true.tolist()], dtype=np.int64)
    cols = np.array([index.get(label, n_labels + 1) for label in y_pred.tolist()], dtype=np.int64)
    weights = np.ones(len(rows), dtype=np.int64) if sample_weight is None else sample_weight
    keep = (rows < n_labels) & (cols < n_labels)
    dtype = np.int64 if weights.dtype.kind in "iub" else np.float64
    cm = np.zeros((n_labels, n_labels), dtype=dtype)
    np.add.at(cm, (rows[keep], cols[keep]), weights[keep].astype(dtype))
    return cm


def balanced_accuracy_score(y_true, y_pred, sample_weight=None, adjusted: bool = False) -> float:
    """The mean recall over the classes of ``y_true``; ``adjusted`` rescales chance to 0."""
    cm = confusion_matrix(y_true, y_pred, sample_weight=sample_weight)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.diag(cm) / cm.sum(axis=1)
    if np.any(np.isnan(per_class)):
        warnings.warn("y_pred contains classes not in y_true")
        per_class = per_class[~np.isnan(per_class)]
    score = np.mean(per_class)
    if adjusted:
        chance = 1 / len(per_class)
        score -= chance
        score /= 1 - chance
    return float(score)


def matthews_corrcoef(y_true, y_pred, sample_weight=None) -> float:
    """The Matthews correlation coefficient of the confusion matrix (0 where undefined)."""
    y_true, y_pred, present, _, sample_weight = _targets(y_true, y_pred, sample_weight)
    cm = confusion_matrix(np.searchsorted(present, y_true), np.searchsorted(present, y_pred),
                          sample_weight=sample_weight)
    t_sum, p_sum = cm.sum(axis=1, dtype=np.float64), cm.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(cm, dtype=np.float64)
    n_samples = p_sum.sum()
    cov_ytyp = n_correct * n_samples - np.dot(t_sum, p_sum)
    cov_ypyp = n_samples ** 2 - np.dot(p_sum, p_sum)
    cov_ytyt = n_samples ** 2 - np.dot(t_sum, t_sum)
    if cov_ypyp * cov_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ypyp * cov_ytyt))


def cohen_kappa_score(y1, y2, labels=None, weights=None, sample_weight=None, replace_undefined_by=np.nan) -> float:
    """Cohen's kappa of two raters' labels; ``weights`` None, ``"linear"`` or ``"quadratic"``."""
    if weights not in (None, "linear", "quadratic"):
        raise ValueError(f"weights must be None, 'linear' or 'quadratic', got {weights!r}")
    confusion = confusion_matrix(y1, y2, labels=labels, sample_weight=sample_weight).astype(np.float64)
    n_classes = confusion.shape[0]
    sum0, sum1 = confusion.sum(axis=0), confusion.sum(axis=1)
    denominator = np.sum(sum0)
    if denominator == 0:
        warnings.warn("cohen_kappa_score is undefined: y2 holds no label that y1 and labels share")
        return replace_undefined_by
    expected = np.outer(sum0, sum1) / denominator
    if weights is None:
        w_mat = np.ones((n_classes, n_classes), dtype=np.float64)
        np.fill_diagonal(w_mat, 0)
    else:
        w_mat = np.zeros((n_classes, n_classes), dtype=np.float64) + np.arange(n_classes)
        w_mat = np.abs(w_mat - w_mat.T) if weights == "linear" else (w_mat - w_mat.T) ** 2
    denominator = np.sum(w_mat * expected)
    if denominator == 0:
        warnings.warn("cohen_kappa_score is undefined: y1, y2 and labels have one label in common")
        return replace_undefined_by
    return float(1 - np.sum(w_mat * confusion) / denominator)


def _set_wise_labels(y_true, y_pred, average, labels, pos_label):
    """sklearn's ``_check_set_wise_labels``: ``[pos_label]`` for a binary average."""
    if average not in AVERAGES and average not in ("binary", "samples"):
        raise ValueError(f"average has to be one of {AVERAGES + ('samples',)} or 'binary', got {average!r}")
    if average == "samples":
        raise ValueError("Samplewise metrics are not available outside of multilabel classification.")
    y_true, y_pred, present, binary, _ = _targets(y_true, y_pred)
    if average == "binary":
        if not binary:
            raise ValueError("Target is multiclass but average='binary'. Please choose another average setting, "
                             f"one of {list(AVERAGES)}.")
        if pos_label not in present and len(present) >= 2:
            raise ValueError(f"pos_label={pos_label} is not a valid label. It should be one of {present}")
        return [pos_label]
    if pos_label not in (None, 1):
        warnings.warn(f"Note that pos_label (set to {pos_label!r}) is ignored when average != 'binary' (got "
                      f"{average!r}). You may use labels=[pos_label] to specify a single positive class.")
    return labels


def _class_sums(y_true, y_pred, sample_weight, labels):
    """Per label of ``labels`` (the present labels where None): true positives, predictions, truths
    and true negatives, as ``multilabel_confusion_matrix`` counts them for label vectors."""
    y_true, y_pred, present, _, sample_weight = _targets(y_true, y_pred, sample_weight)
    if labels is None:
        labels, n_labels = present, None
    else:
        labels = np.asarray(labels)
        n_labels = len(labels)
        labels = np.concatenate([labels, np.setdiff1d(present, labels, assume_unique=True)])
    sorted_labels = np.unique(labels)
    yt, yp = np.searchsorted(sorted_labels, y_true), np.searchsorted(sorted_labels, y_pred)
    hit = yt == yp
    tp_sum = (np.bincount(yt[hit], weights=None if sample_weight is None else sample_weight[hit],
                          minlength=len(labels)) if hit.any() else np.zeros(len(labels)))
    pred_sum = np.bincount(yp, weights=sample_weight, minlength=len(labels))
    true_sum = np.bincount(yt, weights=sample_weight, minlength=len(labels))
    indices = np.searchsorted(sorted_labels, labels[:n_labels])
    tp_sum, pred_sum, true_sum = tp_sum[indices], pred_sum[indices], true_sum[indices]
    fp, fn = pred_sum - tp_sum, true_sum - tp_sum
    total = np.sum(sample_weight) if sample_weight is not None else len(y_true)
    return tp_sum, fp, fn, total - tp_sum - fp - fn


def _zero_division_value(zero_division):
    if isinstance(zero_division, str) and zero_division == "warn":
        return np.float64(0.0)
    if isinstance(zero_division, (int, float)) and zero_division in (0, 1):
        return np.float64(zero_division)
    if isinstance(zero_division, float) and np.isnan(zero_division):
        return np.nan
    raise ValueError(f"zero_division must be 'warn', 0, 1 or nan, got {zero_division!r}")


def _divide(numerator, denominator, metric, zero_division, warn):
    """sklearn's ``_prf_divide``: ``zero_division`` where the denominator is 0."""
    mask = denominator == 0
    denominator = np.array(denominator, dtype=np.float64)
    denominator[mask] = 1
    result = np.asarray(numerator, dtype=np.float64) / denominator
    if mask.any():
        result[mask] = _zero_division_value(zero_division)
        if warn and isinstance(zero_division, str):
            warnings.warn(f"{metric} is ill-defined and being set to 0.0 where it divides by 0. Use "
                          "`zero_division` parameter to control this behavior.")
    return result


def _nanaverage(a, weights=None):
    """sklearn's ``utils/extmath.py:_nanaverage``."""
    if a.shape[0] == 0:
        return np.nan
    mask = np.isnan(a)
    if mask.all():
        return np.nan
    if weights is None:
        return np.nanmean(a)
    a, weights = a[~mask], np.asarray(weights)[~mask]
    try:
        return np.average(a, weights=weights)
    except ZeroDivisionError:  # all weights are zero: they are ignored
        return np.average(a)


def _precision_recall_fscore(y_true, y_pred, beta=1.0, labels=None, pos_label=1, average=None, sample_weight=None,
                             zero_division="warn", warn_for=()):
    _zero_division_value(zero_division)
    labels = _set_wise_labels(y_true, y_pred, average, labels, pos_label)
    tp_sum, fp, fn, _ = _class_sums(y_true, y_pred, sample_weight, labels)
    pred_sum, true_sum = tp_sum + fp, tp_sum + fn
    if average == "micro":
        tp_sum, pred_sum, true_sum = (np.reshape(np.sum(s), (1,)) for s in (tp_sum, pred_sum, true_sum))
    beta2 = beta ** 2
    precision = _divide(tp_sum, pred_sum, "Precision", zero_division, "precision" in warn_for)
    recall = _divide(tp_sum, true_sum, "Recall", zero_division, "recall" in warn_for)
    if np.isposinf(beta):
        f_score = recall
    elif beta == 0:
        f_score = precision
    else:
        denominator = beta2 * true_sum.astype(np.float64) + pred_sum.astype(np.float64)
        f_score = _divide((1 + beta2) * tp_sum.astype(np.float64), denominator, "F-score", zero_division,
                          "f-score" in warn_for)
    if average is None:
        return precision, recall, f_score
    weights = true_sum if average == "weighted" else None
    return tuple(float(_nanaverage(s, weights=weights)) for s in (precision, recall, f_score))


def precision_score(y_true, y_pred, labels=None, pos_label=1, average="binary", sample_weight=None,
                    zero_division="warn"):
    """tp / (tp + fp), per label (``average=None``) or averaged."""
    return _precision_recall_fscore(y_true, y_pred, 1.0, labels, pos_label, average, sample_weight, zero_division,
                                    ("precision",))[0]


def recall_score(y_true, y_pred, labels=None, pos_label=1, average="binary", sample_weight=None,
                 zero_division="warn"):
    """tp / (tp + fn), per label (``average=None``) or averaged."""
    return _precision_recall_fscore(y_true, y_pred, 1.0, labels, pos_label, average, sample_weight, zero_division,
                                    ("recall",))[1]


def fbeta_score(y_true, y_pred, beta, labels=None, pos_label=1, average="binary", sample_weight=None,
                zero_division="warn"):
    """(1 + beta^2) tp / ((1 + beta^2) tp + beta^2 fn + fp), per label or averaged."""
    return _precision_recall_fscore(y_true, y_pred, beta, labels, pos_label, average, sample_weight, zero_division,
                                    ("f-score",))[2]


def f1_score(y_true, y_pred, labels=None, pos_label=1, average="binary", sample_weight=None, zero_division="warn"):
    """``fbeta_score`` with beta 1."""
    return fbeta_score(y_true, y_pred, 1, labels=labels, pos_label=pos_label, average=average,
                       sample_weight=sample_weight, zero_division=zero_division)


def jaccard_score(y_true, y_pred, labels=None, pos_label=1, average="binary", sample_weight=None,
                  zero_division="warn"):
    """tp / (tp + fp + fn), per label (``average=None``) or averaged."""
    labels = _set_wise_labels(y_true, y_pred, average, labels, pos_label)
    tp, fp, fn, _ = _class_sums(y_true, y_pred, sample_weight, labels)
    numerator, denominator = tp, tp + fp + fn
    if average == "micro":
        numerator, denominator = np.sum(numerator, keepdims=True), np.sum(denominator, keepdims=True)
    jaccard = _divide(numerator, denominator, "Jaccard", zero_division, True)
    if average is None:
        return jaccard
    weights = None
    if average == "weighted":
        weights = fn + tp
        if not np.any(weights):
            weights = None
    return float(np.average(jaccard, weights=weights))


# the scores that ClassificationMetric computes in numpy, by their sklearn.metrics name
SCORES = {f.__name__: f for f in (accuracy_score, balanced_accuracy_score, precision_score, recall_score, f1_score,
                                  fbeta_score, jaccard_score, matthews_corrcoef, cohen_kappa_score, hamming_loss,
                                  zero_one_loss)}
