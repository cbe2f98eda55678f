"""Stratified k-fold partitioning of labeled micrographs (port of
topaz_tpu/train/partition.py:11-32, the reference's
topaz/utils/data/partition.py:11-41), without pandas.

Rows are dicts with at least 'source' and 'count'. Images are stratified by
source and by particle-count quantile, then dealt round-robin into k folds.
For the same ``RandomState`` the folds are those of the JAX package, which
takes ``rank(method='first')`` of the counts and ``pd.qcut`` of the ranks
into 5 bins; both are written out here as pandas 3 computes them.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

Row = Dict[str, object]


def qcut_codes(x: np.ndarray, nbins: int) -> np.ndarray:
    """``pd.qcut(x, nbins, labels=False)`` for distinct values: the bin of
    each value between the (linearly interpolated) quantiles, the lowest
    edge included. Raises as pandas does when two edges coincide."""
    quantiles = np.linspace(0, 1, nbins + 1)
    # pandas rounds up, not to nearest, where q/nbins is not exact in base 2
    np.putmask(quantiles, nbins * quantiles != np.arange(nbins + 1),
               np.nextafter(quantiles, 1))
    bins = np.quantile(x, quantiles)
    if len(np.unique(bins)) < len(bins) and len(bins) != 2:
        raise ValueError(f"Bin edges must be unique: {bins!r}.")
    ids = np.searchsorted(bins, x, side="left")
    ids[x == bins[0]] = 1
    return ids - 1


def stratify(rows: List[Row], nbins: int = 5) -> List[List[Row]]:
    """Strata of ``rows``: sources in sorted order, within each the
    count-quantile bins in the order they first appear, rows in input
    order."""
    strata = []
    for source in sorted({r["source"] for r in rows}):
        group = [r for r in rows if r["source"] == source]
        counts = np.array([r["count"] for r in group], dtype=np.float64)
        ranks = np.empty(len(group))
        ranks[np.argsort(counts, kind="stable")] = np.arange(1, len(group) + 1)
        buckets = qcut_codes(ranks, nbins)
        for ident in dict.fromkeys(buckets.tolist()):
            strata.append([r for r, b in zip(group, buckets) if b == ident])
    return strata


def kfold(k: int, rows: List[Row], nbins: int = 5,
          random=np.random) -> Iterator[Tuple[List[Row], List[Row]]]:
    """Yield (train, test) row lists for each of the k folds."""
    order = []
    for stratum in stratify(rows, nbins=nbins):
        order += [stratum[i] for i in random.permutation(len(stratum))]
    folds = [order[i::k] for i in range(k)]
    for i in range(k):
        yield [r for j in range(k) if j != i for r in folds[j]], folds[i]
