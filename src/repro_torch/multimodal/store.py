"""Per-point heterogeneous-feature store for the multi-modal plane (port of
``repro/multimodal/store.py``).

``MultiModalStore`` keeps, on the host, everything the two-stage
retrieval needs beyond the dense ANN backend:

* the fixed-nnz sparse embedding row of every live point (the Grale
  bucket embedding, IDF-weighted at generation time),
* its locality-bucket row (the raw ``generate_buckets`` output: the
  routing key for the sparse candidate stage),
* a count-sketch of its IDF-re-weighted embedding (the ranking vector
  that orders a bucket's posting list per query),
* an inverted bucket -> ids posting index (capped per bucket), and
* an ``IdfCounts`` maintainer fed incrementally from the mutation
  stream, from which ``reload()`` materializes the routing ``IdfTable`` /
  ``FilterTable`` (bitwise equal to a from-scratch build over the same
  corpus).

The host maps and posting lists work as in the reference. The sketches
are computed on the engine's device with the port's ``IdfTable.lookup``
and ``ann.sparse.count_sketch`` (both bitwise the reference's) and copied
to the host; candidates are ranked with the reference's numpy expression,
so the candidate ids come out bitwise. Sketches and posting lists are
updated at the point's upsert time with the routing tables current then;
a ``reload()`` refreshes the tables for queries and future upserts but
does not re-sketch resident points.

``snapshot_state`` gives numpy host data in the reference's format (the
routing tables as ``(sorted_ids, weights, default_weight)`` and
``sorted_ids``, ids as int64); ``restore_state`` takes that
(``convert.multimodal_state`` makes it from the reference's snapshot), so
a restored store answers ``candidates`` identically without replaying the
reload schedule.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ann.sparse import count_sketch
from repro_torch.core.idf import FilterTable, IdfCounts, IdfTable
from repro_torch.core.types import PAD_INDEX, SparseBatch
from repro_torch.multimodal.config import MultiModalConfig
from repro_torch.obs import Telemetry
from repro_torch.utils.device import resolve


def _host(a) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


class MultiModalStore:
    """Host-side multi-modal point store + sparse candidate stage."""

    def __init__(self, cfg: MultiModalConfig, device=None) -> None:
        self.cfg = cfg
        self.device = resolve(device)
        self.counts = IdfCounts()
        self.idf = IdfTable.disabled(self.device)
        self.filter = FilterTable.disabled(self.device)
        self._filtered: set[int] = set()
        self._postings: dict[int, list[int]] = {}
        self._point_buckets: dict[int, np.ndarray] = {}
        self._emb_idx: dict[int, np.ndarray] = {}
        self._emb_val: dict[int, np.ndarray] = {}
        self._sketch: dict[int, np.ndarray] = {}
        self._emb_k = 0
        # lifetime counts survive telemetry rebinds (transfer on bind)
        self.reloads = 0
        self.sparse_candidates = 0
        self.rescored_pairs = 0
        # the store's instruments, on a telemetry plane of its own until an
        # engine binds its shared one
        self.obs = Telemetry()
        self._bind_instruments()

    # ----------------------------------------------------------- telemetry

    def _bind_instruments(self) -> None:
        reg = self.obs.registry
        self._c_reloads = reg.counter(
            "multimodal_reloads_total", "routing-table reloads materialized")
        self._c_sparse = reg.counter(
            "multimodal_sparse_candidates_total",
            "sparse/bucket candidates emitted into the union")
        self._c_rescored = reg.counter(
            "multimodal_rescored_pairs_total",
            "candidate pairs re-scored by the learned MLP")
        self._g_points = reg.gauge(
            "multimodal_points", "live points in the multi-modal store")
        self._g_buckets = reg.gauge(
            "multimodal_buckets", "distinct buckets with posting lists")
        self._h_rescore = reg.histogram(
            "multimodal_rescore_ms", "learned re-score stage per query batch")
        self._c_reloads.inc(self.reloads)
        self._c_sparse.inc(self.sparse_candidates)
        self._c_rescored.inc(self.rescored_pairs)
        self._set_gauges()

    def bind_telemetry(self, telemetry: Telemetry) -> None:
        """Join a shared telemetry plane (``GusEngine`` binds its own);
        lifetime counts transfer over."""
        self.obs = telemetry
        self._bind_instruments()

    def _set_gauges(self) -> None:
        self._g_points.set(len(self._emb_idx))
        self._g_buckets.set(len(self._postings))

    def note_rescore(self, pairs: int, seconds: float) -> None:
        """Called by the retrieval stage after one learned re-score pass
        (its weights on the host, so ``seconds`` covers the device work)."""
        self.rescored_pairs += pairs
        self._c_rescored.inc(pairs)
        self._h_rescore.record(seconds)

    # ------------------------------------------------------------ mutation

    def __len__(self) -> int:
        return len(self._emb_idx)

    def _remove_point(self, pid: int) -> None:
        row = self._point_buckets.pop(pid)
        self.counts.remove(row[None, :], np.ones(row.shape, bool)[None, :])
        for b in np.unique(row).tolist():
            lst = self._postings.get(b)
            if lst is None:
                continue
            try:
                lst.remove(pid)
            except ValueError:
                pass  # never made the capped posting list
            if not lst:
                del self._postings[b]
        del self._emb_idx[pid]
        del self._emb_val[pid]
        del self._sketch[pid]

    def _weighted_sketch(self, emb: SparseBatch) -> np.ndarray:
        """Count-sketch of the IDF-re-weighted embedding rows, f32 [B, d],
        computed on the device and copied to the host."""
        idx = emb.indices.to(self.device)
        vals = emb.values.to(self.device) * self.idf.lookup(idx)
        sketch = count_sketch(SparseBatch(indices=idx, values=vals),
                              self.cfg.d_sketch)
        return sketch.cpu().numpy()

    def upsert(self, ids, emb: SparseBatch, bucket_ids, valid) -> None:
        """Insert/update one batch: ids [B], emb rows [B, K], buckets
        [B, k_max] + valid. Rows are applied in order (last write wins)."""
        self._ingest(ids, emb, bucket_ids, valid, count=True)

    def _ingest(self, ids, emb: SparseBatch, bucket_ids, valid,
                count: bool) -> None:
        ids = np.asarray(ids).reshape(-1)
        bidx = _host(bucket_ids).astype(np.uint32)     # the reference's type
        bval = _host(valid)
        eidx = _host(emb.indices).astype(np.uint32)
        evals = _host(emb.values).astype(np.float32)
        sketches = self._weighted_sketch(emb)
        self._emb_k = eidx.shape[1]
        cap = self.cfg.postings_cap
        for i, pid in enumerate(ids.tolist()):
            pid = int(pid)
            if pid in self._point_buckets:
                self._remove_point(pid)
            row = bidx[i][bval[i]]
            if count:
                self.counts.add(row[None, :],
                                np.ones(row.shape, bool)[None, :])
            self._point_buckets[pid] = row.copy()
            for b in np.unique(row).tolist():
                lst = self._postings.setdefault(b, [])
                if len(lst) < cap:
                    lst.append(pid)
            self._emb_idx[pid] = eidx[i].copy()
            self._emb_val[pid] = evals[i].copy()
            self._sketch[pid] = sketches[i].copy()
        self._set_gauges()

    def delete(self, ids) -> None:
        for pid in np.asarray(ids).reshape(-1).tolist():
            if int(pid) in self._point_buckets:
                self._remove_point(int(pid))
        self._set_gauges()

    def rebuild(self, ids, emb: SparseBatch, bucket_ids, valid) -> None:
        """Reset and re-seed from a full corpus. Counts and routing tables
        materialize first, so the resident points' sketches are computed
        against the fresh tables (incremental upserts sketch against the
        tables current at their apply time instead)."""
        self.counts = IdfCounts()
        self._postings.clear()
        self._point_buckets.clear()
        self._emb_idx.clear()
        self._emb_val.clear()
        self._sketch.clear()
        self.counts.add(_host(bucket_ids).astype(np.uint32), _host(valid))
        self.reload()
        self._ingest(ids, emb, bucket_ids, valid, count=False)

    def reload(self) -> None:
        """Materialize fresh routing tables from the incremental counts."""
        self.idf = self.counts.idf_table(self.cfg.idf_size, self.device)
        self.filter = self.counts.filter_table(self.cfg.filter_percent,
                                               self.device)
        self._filtered = set(self.filter.sorted_ids.cpu().tolist())
        self.reloads += 1
        self._c_reloads.inc()
        self._set_gauges()

    # ------------------------------------------------------------ retrieval

    def candidates(self, bucket_ids, valid, emb: SparseBatch,
                   exclude_ids=None) -> np.ndarray:
        """Sparse/bucket candidate stage: for each query row, the union of
        its (Filter-P-kept) buckets' posting lists, ranked by count-sketch
        dot against the query's re-weighted sketch. int64 [B, sparse_k],
        padded with -1."""
        bidx = _host(bucket_ids).astype(np.uint32)
        bval = _host(valid)
        q_sketch = self._weighted_sketch(emb)
        excl = (None if exclude_ids is None
                else np.asarray(exclude_ids).reshape(-1))
        k = self.cfg.sparse_k
        out = np.full((bidx.shape[0], k), -1, np.int64)
        emitted = 0
        for r in range(bidx.shape[0]):
            cand: set[int] = set()
            for b in np.unique(bidx[r][bval[r]]).tolist():
                if b in self._filtered:
                    continue
                cand.update(self._postings.get(b, ()))
            if excl is not None:
                cand.discard(int(excl[r]))
            if not cand:
                continue
            qs = q_sketch[r]
            ranked = sorted(((-float(qs @ self._sketch[p]), p) for p in cand))
            top = [p for _, p in ranked[:k]]
            out[r, :len(top)] = top
            emitted += len(top)
        self.sparse_candidates += emitted
        self._c_sparse.inc(emitted)
        return out

    def gather_emb(self, ids: np.ndarray) -> tuple:
        """Stored embedding rows for a candidate grid: ids [B, R] ->
        (indices uint32 [B, R, K], values f32 [B, R, K]); missing/-1 rows
        come back all-PAD (their sparse dot is 0)."""
        b, r = ids.shape
        k = self._emb_k
        idx = np.full((b, r, k), PAD_INDEX, np.uint32)
        val = np.zeros((b, r, k), np.float32)
        for i in range(b):
            for j in range(r):
                pid = int(ids[i, j])
                row = self._emb_idx.get(pid)
                if row is not None:
                    idx[i, j] = row
                    val[i, j] = self._emb_val[pid]
        return idx, val

    # ------------------------------------------------ snapshot and restore

    def snapshot_state(self) -> dict:
        pids = sorted(self._emb_idx)
        return {
            "counts": self.counts.snapshot_state(),
            "postings": {int(b): list(v) for b, v in self._postings.items()},
            "ids": np.array(pids, np.int64),
            "point_buckets": [self._point_buckets[p].copy() for p in pids],
            "emb_idx": [self._emb_idx[p].copy() for p in pids],
            "emb_val": [self._emb_val[p].copy() for p in pids],
            "sketch": [self._sketch[p].copy() for p in pids],
            "emb_k": self._emb_k,
            "reloads": self.reloads,
            # host arrays only, in the reference's layout:
            # (sorted_ids, weights, default_weight) and sorted_ids
            "idf": (self.idf.sorted_ids.cpu().numpy(),
                    self.idf.weights.cpu().numpy(),
                    self.idf.default_weight.cpu().numpy()),
            "filter": self.filter.sorted_ids.cpu().numpy(),
        }

    def restore_state(self, state: dict) -> None:
        self.counts = IdfCounts()
        self.counts.restore_state(state["counts"])
        self._postings = {int(b): list(v)
                          for b, v in state["postings"].items()}
        pids = [int(p) for p in np.asarray(state["ids"]).tolist()]
        self._point_buckets = {
            p: np.asarray(row, np.uint32)
            for p, row in zip(pids, state["point_buckets"])}
        self._emb_idx = {p: np.asarray(row, np.uint32)
                         for p, row in zip(pids, state["emb_idx"])}
        self._emb_val = {p: np.asarray(row, np.float32)
                         for p, row in zip(pids, state["emb_val"])}
        self._sketch = {p: np.asarray(row, np.float32)
                        for p, row in zip(pids, state["sketch"])}
        self._emb_k = int(state["emb_k"])
        self.reloads = int(state["reloads"])
        ids, weights, default = state["idf"]
        dev = self.device

        def table(a, dtype):
            return torch.as_tensor(np.array(a, dtype), device=dev)

        self.idf = IdfTable(table(ids, np.int64), table(weights, np.float32),
                            table(default, np.float32))
        self.filter = FilterTable(table(state["filter"], np.int64))
        self._filtered = set(self.filter.sorted_ids.cpu().tolist())
        self._set_gauges()

    def describe(self) -> dict:
        return {
            "points": len(self._emb_idx),
            "buckets": len(self._postings),
            "reloads": self.reloads,
            "sparse_candidates": self.sparse_candidates,
            "rescored_pairs": self.rescored_pairs,
        }
