"""Graph assembly + the edge-weight-distribution metric of paper §5 (a
copy of ``repro/core/graph.py``: host numpy, no device work).

The paper's quality plots report "edge weight at each percentile of edges
ordered by weight" (Figs. 3-8) and compare algorithms at matched total edge
counts. ``edge_weight_percentiles`` reproduces that statistic;
``GraphAccumulator`` turns per-query NeighborResults into a deduped
undirected edge list (the "graph" of graph building).
"""
from __future__ import annotations

import numpy as np


def canonical_max_edges(a: np.ndarray, b: np.ndarray, w: np.ndarray
                        ) -> tuple:
    """Canonicalize directed (a, b, w) records to undirected edges, deduped
    at max weight: returns (pairs int64 [E, 2] with pair[0] < pair[1],
    lexicographically sorted; weights float64 [E])."""
    if a.size == 0:
        return np.zeros((0, 2), np.int64), np.zeros((0,), np.float64)
    pairs = np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    best = np.full((uniq.shape[0],), -np.inf)
    np.maximum.at(best, inv.reshape(-1), w.astype(np.float64))
    return uniq.astype(np.int64), best


class GraphAccumulator:
    """Collects (src, dst, weight) edges; canonicalizes to undirected.

    The hot loops are vectorized: canonicalize + dedup-at-max-weight run in
    numpy (``np.maximum.at`` over the batch's unique pairs) and only the
    deduped survivors touch the Python dict, which stays the output format
    for the percentile metric.
    """

    def __init__(self):
        self._edges: dict[tuple, float] = {}

    def _accumulate(self, a: np.ndarray, b: np.ndarray,
                    w: np.ndarray) -> None:
        uniq, best = canonical_max_edges(a, b, w)
        for (x, y), bw in zip(uniq.tolist(), best.tolist()):
            key = (x, y)
            prev = self._edges.get(key)
            if prev is None or bw > prev:
                self._edges[key] = bw

    def add_result(self, src_ids: np.ndarray, result) -> None:
        ids = np.asarray(result.ids)
        weights = np.asarray(result.weights)
        src = np.broadcast_to(np.asarray(src_ids).reshape(-1, 1), ids.shape)
        keep = (ids >= 0) & (ids != src) & np.isfinite(weights)
        self._accumulate(src[keep], ids[keep], weights[keep])

    def add_pairs(self, pairs: np.ndarray, weights: np.ndarray) -> None:
        pairs = np.asarray(pairs).reshape(-1, 2)
        weights = np.asarray(weights).reshape(-1)
        keep = pairs[:, 0] != pairs[:, 1]
        self._accumulate(pairs[keep, 0], pairs[keep, 1], weights[keep])

    def edges(self) -> tuple:
        if not self._edges:
            return np.zeros((0, 2), np.int64), np.zeros((0,), np.float32)
        pairs = np.asarray(sorted(self._edges), np.int64)
        weights = np.asarray([self._edges[tuple(p)] for p in pairs], np.float32)
        return pairs, weights

    def __len__(self):
        return len(self._edges)


def edge_weight_percentiles(weights: np.ndarray,
                            qs=(1, 5, 10, 20, 30, 40, 50, 60, 70, 80, 90, 99)
                            ) -> dict:
    """Paper Figs. 3-8 statistic: weight at each percentile of the edge set
    ordered by weight (ascending), plus the total edge count."""
    weights = np.asarray(weights)
    if weights.size == 0:
        return {"total_edges": 0}
    out = {"total_edges": int(weights.size)}
    for q in qs:
        out[f"p{q}"] = float(np.percentile(weights, q))
    return out


def frac_above(weights: np.ndarray, threshold: float) -> float:
    """E.g. "more than 97% of the edges ... have weight above 0.25"."""
    weights = np.asarray(weights)
    if weights.size == 0:
        return 0.0
    return float(np.mean(weights > threshold))


def edge_sets_equal(pairs_a: np.ndarray, pairs_b: np.ndarray) -> bool:
    """Exact edge-set equality (Lemma 4.1 check: Grale == GUS)."""
    a = {tuple(sorted(p)) for p in np.asarray(pairs_a).tolist()}
    b = {tuple(sorted(p)) for p in np.asarray(pairs_b).tolist()}
    return a == b
