"""Average precision, precision-recall curves, prediction-to-target
matching and the file-level curve of ``precision_recall_curve`` (port of
topaz_tpu/ops/metrics.py:19-134, the reference's topaz/metrics.py:10-152
and topaz/algorithms.py:7-22).

Predictions with identical scores are pooled into one bucket before
precision and recall are computed, so AP does not depend on how ties are
ordered; AP = sum over buckets of precision x recall mass, over N (which may
exceed the number of matched targets). Host numpy, but for
``average_precision_tensor``, which training's evaluation runs on the
device; matching is scipy's Hungarian assignment.
"""

from __future__ import annotations

import sys
from typing import IO, Dict, Optional, Tuple

import numpy as np
import torch


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


def average_precision_tensor(target: torch.Tensor, pred: torch.Tensor,
                             N: Optional[int] = None) -> float:
    """``average_precision`` of two tensors on their device, with the same
    tie buckets: one sort on the device in place of the host's argsort of
    every pixel (28 M voxels of a 192 x 384 x 384 tomogram take seconds on
    the host); counts and sums in float64."""
    order = torch.argsort(pred, descending=True, stable=True)
    scores, hits = pred[order], target[order].to(torch.float64)
    is_end = torch.ones_like(scores, dtype=torch.bool)
    is_end[:-1] = scores[:-1] != scores[1:]
    tp = torch.cumsum(hits, 0)[is_end]
    pp = torch.nonzero(is_end)[:, 0].to(torch.float64) + 1
    r = torch.diff(tp, prepend=tp.new_zeros(1))
    n = hits.sum() if N is None else N
    return float(torch.sum(tp / pp * r) / n)


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


def _read_table(path: str, comment: bool = False) -> Dict[str, np.ndarray]:
    """A tab-separated table as pandas' ``read_csv(sep="\\t")`` types it
    (``parse_column``); with ``comment``, text from a '#' on is dropped and
    lines left empty are skipped (``comment="#"``)."""
    from topaz_tpu_torch.io.table import parse_column

    with open(path) as f:
        lines = [line.rstrip("\r\n") for line in f]
    if comment:
        lines = [line.split("#", 1)[0] for line in lines]
    rows = [line.split("\t") for line in lines if line.strip()]
    header, rows = rows[0], rows[1:]
    return {name: parse_column([r[i] for r in rows]) for i, name in enumerate(header)}


def _unique(values: np.ndarray) -> list:
    """Distinct values in order of first appearance (pandas' ``unique``)."""
    return list(dict.fromkeys(values.tolist()))


def particle_prc(targets_path: str, predicted_path: str, match_radius: int,
                 images: str = "target", out: Optional[IO[str]] = None) -> None:
    """Precision-recall of scored picks against target coordinates, each
    image's picks matched to its targets by Hungarian assignment within
    ``match_radius``; prints '# auprc=..., mae=...' and the tab-separated
    (threshold, precision, recall, f1) table (topaz/metrics.py:92-152).
    ``images``: the images counted, those of the targets, of the predictions
    or of either ("target", "predicted", "union"). The output is byte-equal
    to the JAX package's: the images are visited in the order of a Python
    set built as it builds it, so the running mean of the match distance
    sums in its order."""
    out = out or sys.stdout
    targets = _read_table(targets_path)
    predicts = _read_table(predicted_path, comment=True)

    if images == "union":
        image_list = set(_unique(targets["image_name"])) | set(_unique(predicts["image_name"]))
    elif images == "target":
        image_list = set(_unique(targets["image_name"]))
    elif images == "predicted":
        image_list = set(_unique(predicts["image_name"]))
    else:
        raise ValueError("Unknown image argument: " + images)

    N = len(targets["image_name"])
    matches, scores = [], []
    count, mae = 0, 0.0
    for name in image_list:
        t = targets["image_name"] == name
        p = predicts["image_name"] == name
        match, dist = match_coordinates(
            np.stack([targets["x_coord"][t], targets["y_coord"][t]], axis=1),
            np.stack([predicts["x_coord"][p], predicts["y_coord"][p]], axis=1),
            match_radius)
        this_mae = np.sum(dist[match == 1])
        count += np.sum(match)
        if count > 0:
            mae += (this_mae - np.sum(match) * mae) / count
        matches.append(match)
        scores.append(predicts["score"][p].astype(np.float32))

    matches = np.concatenate(matches, 0)
    scores = np.concatenate(scores, 0)
    precision, recall, threshold, auprc = precision_recall_curve(matches, scores, N=N)
    print(f"# auprc={auprc}, mae={np.sqrt(mae)}", file=out)

    mask = (precision + recall) == 0
    f1 = 2 * precision * recall
    f1[mask] = 0
    f1[~mask] /= (precision + recall)[~mask]
    # the columns as pandas' to_csv writes them: numpy's shortest repr
    print("threshold\tprecision\trecall\tf1", file=out)
    for row in zip(threshold, precision, recall, f1):
        print("\t".join(str(v) for v in row), file=out)
