"""Offline Grale baseline (Halcrow et al., KDD'20; paper §4, §5), port of
``repro/core/grale.py``: LSH bucket ids per point -> inverted bucket index
-> every within-bucket pair is a scoring pair -> score with the model.

The bucket join runs on the host in numpy (an offline batch job in the
paper too); pair scoring goes through the port's scorer (``score_pairs``:
the scorer kernel on the card, its plain version on the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.scorer import score_pairs
from repro_torch.core.types import FeatureSpec


@dataclasses.dataclass(frozen=True)
class GraleConfig:
    bucket_split: int | None = None   # Bucket-S (None = unbounded, Fig. 3 mode)
    top_k: int | None = None          # Top-K output pruning
    score_batch: int = 8192
    seed: int = 0


def _split_large_buckets(bucket_of: np.ndarray, max_size: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Randomly subdivide buckets with more than ``max_size`` members by
    re-tagging members with a random sub-bucket id (paper §5 "Bucket size
    for Grale")."""
    out = bucket_of.astype(np.uint64).copy()
    uniq, inverse, counts = np.unique(out, return_inverse=True,
                                      return_counts=True)
    for b in np.nonzero(counts > max_size)[0]:
        sel = np.nonzero(inverse == b)[0]
        n_sub = int(np.ceil(sel.size / max_size))
        sub = rng.integers(0, n_sub, sel.size).astype(np.uint64)
        out[sel] = (out[sel] << np.uint64(8)) ^ sub  # disjoint sub-bucket ids
    return out


def scoring_pairs(bucket_ids: np.ndarray, valid: np.ndarray,
                  cfg: GraleConfig) -> np.ndarray:
    """All within-bucket pairs (i < j), deduped across buckets.

    bucket_ids: integer [N, L]; valid: bool [N, L]. Returns int64 [E, 2].
    """
    n, l = bucket_ids.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), l)
    flat = bucket_ids.reshape(-1).astype(np.uint64)
    keep = valid.reshape(-1)
    rows, flat = rows[keep], flat[keep]

    if cfg.bucket_split is not None:
        flat = _split_large_buckets(flat, cfg.bucket_split,
                                    np.random.default_rng(cfg.seed))

    order = np.argsort(flat, kind="stable")
    flat, rows = flat[order], rows[order]
    boundaries = np.nonzero(np.diff(flat))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [flat.size]])

    pairs = []
    for s, e in zip(starts, ends):
        members = np.unique(rows[s:e])
        if members.size < 2:
            continue
        ii, jj = np.triu_indices(members.size, k=1)
        pairs.append(np.stack([members[ii], members[jj]], axis=1))
    if not pairs:
        return np.zeros((0, 2), np.int64)
    return np.unique(np.concatenate(pairs), axis=0)


def score_edges(pairs: np.ndarray, features: dict, spec: FeatureSpec,
                scorer_params: dict, batch: int = 8192) -> np.ndarray:
    """Model-score each (i, j) pair; returns float32 [E]."""
    out = np.empty((pairs.shape[0],), np.float32)
    for lo in range(0, pairs.shape[0], batch):
        chunk = pairs[lo:lo + batch]
        fa = {k: v[chunk[:, 0]] for k, v in features.items()}
        fb = {k: v[chunk[:, 1]] for k, v in features.items()}
        out[lo:lo + chunk.shape[0]] = score_pairs(
            scorer_params, fa, fb, spec).cpu().numpy()
    return out


def top_k_per_point(pairs: np.ndarray, weights: np.ndarray, n_points: int,
                    k: int) -> np.ndarray:
    """Keep each point's k highest-weight incident edges (union over
    endpoints, as in Grale's post-processing). Returns a bool keep-mask."""
    keep = np.zeros(pairs.shape[0], bool)
    # directed views: each endpoint ranks its incident edges
    for col in (0, 1):
        order = np.lexsort((-weights, pairs[:, col]))
        pts = pairs[order, col]
        # pts is sorted: searchsorted gives each element's first occurrence,
        # so rank = position within its point's (weight-descending) group.
        first = np.searchsorted(pts, pts, side="left")
        rank = np.arange(pts.size) - first
        keep[order[rank < k]] = True
    return keep


def grale_graph(bucket_ids: np.ndarray, valid: np.ndarray, features: dict,
                spec: FeatureSpec, scorer_params: dict,
                cfg: GraleConfig = GraleConfig()):
    """End-to-end offline Grale. Returns (pairs int64 [E,2], weights f32 [E])."""
    pairs = scoring_pairs(bucket_ids, valid, cfg)
    weights = score_edges(pairs, features, spec, scorer_params, cfg.score_batch)
    if cfg.top_k is not None and pairs.shape[0]:
        n = int(max(bucket_ids.shape[0], pairs.max() + 1))
        keep = top_k_per_point(pairs, weights, n, cfg.top_k)
        pairs, weights = pairs[keep], weights[keep]
    return pairs, weights
