"""Two-stage multi-modal retrieval, the live Grale scoring path (port of
``repro/multimodal/retrieve.py``).

Stage 1, candidate union: the dense ANN backend's shortlist is unioned
with the sparse/locality-bucket stage (``MultiModalStore.candidates``:
Filter-P-kept query buckets route into capped posting lists, ranked by
count-sketch dots of the IDF-re-weighted embeddings). Either stage can
recover points the other misses: a fresh point whose dense embedding has
not converged still shares buckets with its sparse neighbors.

Stage 2, learned re-score: the exact distances are negative sparse dots
over the stored embedding rows (the paper's Dist(p, q) = -M(p)·M(q)),
from the ``sparse_dot_batched`` kernel on the card; every candidate pair
is then scored by ``core.scorer.score_pairs`` (the ``pair_score`` kernel:
pair features and the MLP in one launch, each query row read once for
its ``r_max`` candidates, so the query rows are not repeated on the
host). The final top-k is ordered by re-scored weight, so the maintained
graph consumes learned multi-modal similarity.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.scorer import score_pairs
from repro_torch.core.types import NeighborResult
from repro_torch.kernels import ops


def two_stage_neighbors(gus, features, k: int, exclude_ids=None,
                        emb=None, buckets=None) -> NeighborResult:
    """Candidate union + learned re-score for a ``DynamicGUS`` with a
    configured multi-modal plane. ``emb`` / ``buckets`` take the staged
    encode artifacts (the pipelined graph tick): both are pure functions of
    ``features``, so passing them is a pure reuse."""
    mm = gus.multimodal
    if emb is None:
        emb = gus.embedder(features)
    if buckets is None:
        b_ids, b_valid = gus.embedder.buckets(features)
        buckets = (b_ids.cpu().numpy(), b_valid.cpu().numpy())
    dense_ids, _ = gus.index.search(emb, k + (exclude_ids is not None))
    dense_ids = np.asarray(dense_ids)
    sparse_ids = mm.candidates(buckets[0], buckets[1], emb,
                               exclude_ids=exclude_ids)
    n_rows = dense_ids.shape[0]
    r_max = dense_ids.shape[1] + sparse_ids.shape[1]
    cand = np.full((n_rows, r_max), -1, np.int64)
    excl = (None if exclude_ids is None
            else np.asarray(exclude_ids).reshape(-1))
    for r in range(n_rows):
        seen: set[int] = set()
        col = 0
        for pid in dense_ids[r].tolist() + sparse_ids[r].tolist():
            pid = int(pid)
            if pid < 0 or pid in seen:
                continue
            if excl is not None and pid == int(excl[r]):
                continue
            seen.add(pid)
            cand[r, col] = pid
            col += 1
    # exact sparse distances over the union (stored embedding rows)
    db_idx, db_val = mm.gather_emb(cand)
    dev = gus.device
    dots = ops.sparse_dot_batched(
        emb.indices, emb.values,
        torch.as_tensor(db_idx.astype(np.int64), device=dev),
        torch.as_tensor(db_val, device=dev))
    dists = np.where(cand >= 0, -dots.cpu().numpy(), np.inf).astype(
        np.float32)
    # learned re-score of every candidate pair; the timer ends with the
    # weights on the host
    t0 = time.perf_counter()
    cand_feats = gus.store.gather(cand)
    flat_c = {kk: v.reshape((-1,) + v.shape[2:])
              for kk, v in cand_feats.items()}
    weights = score_pairs(gus.scorer_params, features, flat_c, gus.spec,
                          group=r_max).cpu().numpy()
    weights = weights.reshape(cand.shape)
    weights = np.where(cand >= 0, weights, -np.inf).astype(np.float32)
    mm.note_rescore(int((cand >= 0).sum()), time.perf_counter() - t0)
    order = np.argsort(-weights, axis=-1, kind="stable")[:, :k]
    return NeighborResult(
        ids=np.take_along_axis(cand, order, axis=1),
        weights=np.take_along_axis(weights, order, axis=1),
        distances=np.take_along_axis(dists, order, axis=1))
