"""Binary ranking metrics in numpy, with scikit-learn's semantics.

The JAX package's evaluator takes `roc_curve`, `roc_auc_score`,
`precision_recall_curve` and `average_precision_score` from
scikit-learn (as the reference does); the port computes the same
numbers here, so that evaluation needs numpy only. Each function follows
scikit-learn's binary case (`sklearn/metrics/_ranking.py`): scores
ranked by a stable descending sort, one point per distinct score,
`roc_curve` dropping collinear points and starting at (0, 0) with an
infinite threshold, NaN rates (with a warning) where a class is absent.
"""

from __future__ import annotations

import warnings
from typing import Sequence, Tuple

import numpy as np


def _binary_clf_curve(y_true: Sequence, y_score: Sequence,
                      pos_label: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """False and true positive counts at each distinct score, highest
    first, and those scores."""
    y_true = np.ravel(np.asarray(y_true)) == pos_label
    y_score = np.ravel(np.asarray(y_score))
    order = np.argsort(y_score, kind='mergesort')[::-1]
    y_score = y_score[order]
    y_true = y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true * 1.0, dtype=np.float64)[idx]
    fps = 1 + idx - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true: Sequence, y_score: Sequence, pos_label: int = 1,
              drop_intermediate: bool = True
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) of a binary ranking."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score, pos_label)
    if drop_intermediate and len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)),
                              True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    if fps[-1] <= 0:
        warnings.warn('No negative samples in y_true, false positive '
                      'value should be meaningless')
        fpr = np.repeat(np.nan, fps.shape)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        warnings.warn('No positive samples in y_true, true positive '
                      'value should be meaningless')
        tpr = np.repeat(np.nan, tps.shape)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under y(x), x monotonic either way."""
    dx = np.diff(x)
    direction = 1
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f'x is neither increasing nor decreasing: {x}')
        direction = -1
    trapezoid = getattr(np, 'trapezoid', None) or np.trapz
    return float(direction * trapezoid(y, x))


def roc_auc_score(y_true: Sequence, y_score: Sequence) -> float:
    """Area under the ROC curve of a binary ranking (the larger label
    positive); both labels must be present."""
    y_true = np.ravel(np.asarray(y_true))
    labels = np.unique(y_true)
    if len(labels) != 2:
        raise ValueError('Only one class present in y_true. ROC AUC score '
                         'is not defined in that case.')
    fpr, tpr, _ = roc_curve(y_true == labels[1], y_score, pos_label=1)
    return auc(fpr, tpr)


def precision_recall_curve(y_true: Sequence, y_score: Sequence,
                           pos_label: int = 1
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(precision, recall, thresholds), recall decreasing, ending at
    (1, 0)."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score, pos_label)
    ps = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, ps, out=precision, where=(ps != 0))
    if tps[-1] == 0:
        warnings.warn('No positive class found in y_true, recall is set '
                      'to one for all thresholds')
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    rev = slice(None, None, -1)
    return (np.hstack((precision[rev], 1)), np.hstack((recall[rev], 0)),
            thresholds[rev])


def average_precision_score(y_true: Sequence, y_score: Sequence,
                            pos_label: int = 1) -> float:
    """Step-wise (uninterpolated) average precision of a binary
    ranking, at least 0.0."""
    present = np.unique(np.asarray(y_true)).tolist()
    if len(present) == 2 and pos_label not in present:
        raise ValueError(f'pos_label={pos_label} is not a valid label. It '
                         f'should be one of {present}')
    precision, recall, _ = precision_recall_curve(y_true, y_score,
                                                  pos_label)
    # the step integral; rounding can give -0.0, clipped to 0.0
    return float(max(0.0, -np.sum(np.diff(recall)
                                  * np.asarray(precision)[:-1])))
