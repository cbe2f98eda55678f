"""Average precision, precision-recall curves and prediction-to-target
matching (port of topaz_tpu/ops/metrics.py:19-56, 110-134, the reference's
topaz/metrics.py:10-89 and topaz/algorithms.py:7-22).

Predictions with identical scores are pooled into one bucket before
precision and recall are computed, so AP does not depend on how ties are
ordered; AP = sum over buckets of precision x recall mass, over N (which may
exceed the number of matched targets). Host numpy: it runs once an epoch on
fetched scores; matching is scipy's Hungarian assignment.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _bucketed_counts(target: np.ndarray, pred: np.ndarray):
    """Sort by descending score, pool ties, return per-bucket cumulative
    (predicted positives, true positives)."""
    order = np.argsort(pred, kind="stable")[::-1]
    scores = pred[order]
    hits = target[order]
    # bucket ends: last index of each distinct score
    is_end = np.ones(len(scores), dtype=bool)
    is_end[:-1] = scores[:-1] != scores[1:]
    pp = np.flatnonzero(is_end) + 1            # cumulative predictions
    tp = np.cumsum(hits)[is_end]               # cumulative true positives
    return scores[is_end], pp, tp


def precision_recall_curve(target, pred, N: Optional[int] = None):
    """(precision, recall, threshold, average_precision) per score bucket
    (topaz/metrics.py:10-50)."""
    target = np.asarray(target, dtype=np.float32)
    pred = np.asarray(pred, dtype=np.float32)
    n = target.sum() if N is None else N
    thresholds, pp, tp = _bucketed_counts(target, pred)
    r = np.diff(np.concatenate([[0], tp]))
    pr = tp / pp
    pr[np.isnan(pr)] = 1
    avpr = np.sum(pr * r) / n
    re = tp / n
    return pr, re, thresholds, avpr


def average_precision(target, pred, N: Optional[int] = None) -> float:
    """Tie-bucketed average precision (topaz/metrics.py:53-89)."""
    target = np.asarray(target, dtype=np.float32)
    pred = np.asarray(pred, dtype=np.float32)
    n = target.sum() if N is None else N
    _, pp, tp = _bucketed_counts(target, pred)
    r = np.diff(np.concatenate([[0], tp]))
    pr = tp / pp
    return float(np.sum(pr * r) / n)


def match_coordinates(targets, preds, radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """Optimal 1:1 matching of predictions to targets within ``radius``
    (topaz_tpu/ops/metrics.py:110-134, topaz/algorithms.py:7-22): Hungarian
    assignment on the radius-capped squared distance, on the host. Returns
    (assignment in {0, 1} a prediction, float32; distance to the matched
    target a prediction, float64, 0 where unmatched)."""
    from scipy.optimize import linear_sum_assignment

    targets = np.asarray(targets, dtype=np.float64)
    preds = np.asarray(preds, dtype=np.float64)
    if len(preds) == 0 or len(targets) == 0:
        return np.zeros(len(preds), dtype=np.float32), np.zeros(len(preds))

    d2 = np.sum((preds[:, None] - targets[None]) ** 2, axis=2)
    cost = np.minimum(d2 - radius * radius, 0)
    pred_index, target_index = linear_sum_assignment(cost)
    matched_cost = cost[pred_index, target_index]

    dist = np.zeros(len(preds))
    dist[pred_index] = np.sqrt(d2[pred_index, target_index])
    assignment = np.zeros(len(preds), dtype=np.float32)
    assignment[pred_index[matched_cost < 0]] = 1
    return assignment, dist
