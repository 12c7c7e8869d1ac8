"""Dynamic GUS (port of ``repro/core/gus.py``, paper §3): Embedding
Generator + ScaNN-style index + Similarity Scorer behind the two RPC
surfaces, mutations and neighborhoods, plus the offline bootstrap and the
maintained graph (``GusConfig.graph``): every mutation RPC updates the
graph, and ``neighbors_of_ids`` at k <= the graph's k serves straight
from its rows.

Backends ``"scann"`` and the exact ``"brute"``; the multi-modal plane,
the sharded backend and the serving plane's pipeline and maintenance
worker are not ported. The neighborhood RPC's pair scores go through the
scorer kernel on the card. Per-RPC wall-clock timers mirror the paper's
Figs. 9-10; results are copied to the host inside the timed block, so
each sample covers the device work; graph maintenance is billed to
``graph_timer``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from repro_torch.ann.brute import BruteIndex
from repro_torch.ann.scann import ScannConfig, ScannIndex
from repro_torch.core import idf as idf_mod
from repro_torch.core.buckets import BucketConfig
from repro_torch.core.embedding import EmbeddingGenerator
from repro_torch.core.maintenance import MaintenanceConfig
from repro_torch.core.scorer import score_pairs
from repro_torch.core.types import (FeatureSpec, MutationBatch, NeighborResult,
                                    MUTATION_DELETE)
from repro_torch.graph.store import DynamicGraphStore, GraphConfig
from repro_torch.utils.device import resolve
from repro_torch.utils.timing import Timer


@dataclasses.dataclass
class StagedMutation:
    """A mutation batch split at the encode/apply boundary."""
    n: int                                  # points acknowledged
    dels: np.ndarray | None                 # ids to tombstone
    up_ids: np.ndarray | None               # ids to insert/update
    feats: dict | None                      # store-normalized features
    emb: object | None                      # SparseBatch embeddings
    index_staged: object | None             # backend encode artifacts
    pending: object | None = None           # in-flight device handle


@dataclasses.dataclass(frozen=True)
class GusConfig:
    scann_nn: int = 10           # ScaNN-NN: neighbors retrieved from the index
    idf_size: int = 0            # IDF-S   : IDF table size (0 = unit weights)
    filter_percent: float = 0.0  # Filter-P: % of most popular buckets dropped
    backend: str = "scann"       # "scann" | "brute"
    scann: ScannConfig = ScannConfig()
    # maintained-graph layer (repro_torch.graph): None disables maintenance;
    # its `maintenance.staleness_bound > 0` serves published versions
    graph: GraphConfig | None = None


def make_index(k_dims: int, cfg: GusConfig, device):
    """ANN backend factory — every backend speaks build/upsert/delete/search."""
    if cfg.backend == "brute":
        return BruteIndex(k_dims, device=device)
    if cfg.backend == "scann":
        return ScannIndex(k_dims, cfg.scann, device)
    raise ValueError(f"unknown GUS backend {cfg.backend!r} (this port has "
                     "'scann' and 'brute')")


class FeatureStore:
    """Host-side feature store keyed by point id (numpy columns)."""

    def __init__(self, spec: FeatureSpec):
        self.spec = spec
        self._rows: dict[int, dict] = {}

    def put(self, ids: np.ndarray, features: Mapping[str, np.ndarray]) -> None:
        for i, pid in enumerate(np.asarray(ids).tolist()):
            self._rows[pid] = {k: np.asarray(v[i]) for k, v in features.items()}

    def drop(self, ids) -> None:
        for pid in np.asarray(ids).tolist():
            self._rows.pop(pid, None)

    def clear(self) -> None:
        self._rows.clear()

    def ids(self) -> np.ndarray:
        """Live point ids, ascending."""
        return np.asarray(sorted(self._rows), np.int64)

    def gather(self, ids: np.ndarray) -> dict:
        """Batch features for ids (missing ids get zeros)."""
        ids = np.asarray(ids)
        proto = self.spec.feature_shapes(1)
        out = {k: np.zeros((ids.size,) + shape[1:], dtype)
               for k, (shape, dtype) in proto.items()}
        for j, pid in enumerate(ids.reshape(-1).tolist()):
            row = self._rows.get(pid)
            if row is not None:
                for k, v in row.items():
                    out[k][j] = v
        return {k: v.reshape(ids.shape + v.shape[1:]) for k, v in out.items()}


class DynamicGUS:
    """The Dynamic Grale Using ScaNN engine, on one device."""

    def __init__(self, spec: FeatureSpec, bucket_cfg: BucketConfig,
                 scorer_params: dict, cfg: GusConfig = GusConfig(),
                 device=None):
        self.device = resolve(device)
        self.spec = spec
        self.cfg = cfg
        self.maintenance = (cfg.graph.maintenance if cfg.graph is not None
                            else MaintenanceConfig())
        self.embedder = EmbeddingGenerator.create(spec, bucket_cfg,
                                                  self.device)
        self.scorer_params = {k: v.to(self.device)
                              for k, v in scorer_params.items()}
        self.store = FeatureStore(spec)
        self.index = make_index(self.embedder.k_max, cfg, self.device)
        self.graph = (DynamicGraphStore(cfg.graph, self.device)
                      if cfg.graph else None)
        # applied mutation batches: published graph versions are stamped
        # against this count
        self.seq_applied = 0
        self.mutation_timer = Timer("mutation")
        self.query_timer = Timer("neighbors")
        self.graph_timer = Timer("graph")

    # ----------------------------------------------------- offline (§4.3)

    def bootstrap(self, ids: np.ndarray, features: Mapping[str, np.ndarray]
                  ) -> None:
        """Offline preprocessing: compute IDF/filter tables from the initial
        corpus, (re)build the index, and load all points. The maintained
        graph (if configured) is seeded from full-corpus neighborhoods in
        chunks of 256 ids, then its repair queue is drained."""
        bucket_ids, valid = self.embedder.buckets(features)
        bucket_ids = bucket_ids.cpu().numpy()
        valid = valid.cpu().numpy()
        n = len(ids)
        self.embedder = self.embedder.reload(
            idf=idf_mod.build_idf_table(bucket_ids, valid, n,
                                        self.cfg.idf_size, self.device),
            filter_table=idf_mod.build_filter_table(
                bucket_ids, valid, self.cfg.filter_percent, self.device))
        self.index.build(np.asarray(ids), self.embedder(features))
        self.store.put(ids, features)
        self.seed_graph(ids)

    def seed_graph(self, ids: np.ndarray) -> None:
        """Start a fresh maintained graph over the loaded corpus ``ids``:
        their neighborhoods in chunks of 256, then a repair flush."""
        if self.graph is not None:
            self.graph = DynamicGraphStore(self.cfg.graph, self.device)
            with self.graph_timer:
                self.graph.ensure_ids(np.asarray(ids))
                for lo in range(0, len(ids), 256):
                    chunk = np.asarray(ids[lo:lo + 256])
                    self.graph.upsert(chunk, self._index_neighbors_of_ids(
                        chunk, self.graph.cfg.probe_k(), timed=False))
                self.flush_graph_repair(limit=len(ids))
            if self.maintenance.staleness_bound > 0:
                self.graph.publish(seq=self.seq_applied)

    # ------------------------------------------------------ mutation RPCs

    def mutate(self, batch: MutationBatch) -> int:
        """Insert / update / delete a batch of points (paper §3.3.1-.2).
        Returns the number of points acknowledged. With a maintained graph,
        every mutation also updates it (timed apart in ``graph_timer``):
        deletes tombstone the row and purge back-edges; upserts re-query
        the point's scored neighborhood and apply two-sided edge updates;
        then one repair drain."""
        with self.mutation_timer:
            staged = self.encode_mutation(batch)
            self.apply_mutation(staged)
            self.finish_mutation(staged)
        self.seq_applied += 1
        if self.graph is not None:
            with self.graph_timer:
                self.graph_apply(staged)
                self.flush_graph_repair()
            if self.maintenance.staleness_bound > 0:
                self.graph.publish(seq=self.seq_applied)
        return staged.n

    def encode_mutation(self, batch: MutationBatch) -> StagedMutation:
        """Stage A: parse the batch, normalize features to the store's
        dtypes, embed, and run the backend's pure encode."""
        kinds = np.asarray(batch.kinds)
        ids = np.asarray(batch.ids)
        del_mask = kinds == MUTATION_DELETE
        dels = ids[del_mask] if del_mask.any() else None
        up_ids = feats = emb = index_staged = None
        up_mask = ~del_mask
        if up_mask.any():
            up_ids = ids[up_mask]
            proto = self.spec.feature_shapes(1)
            feats = {k: np.asarray(v)[up_mask].astype(proto[k][1], copy=False)
                     for k, v in batch.features.items()}
            emb = self.embedder(feats)
            index_staged = self.index.encode_upsert(up_ids, emb)
        return StagedMutation(n=int(ids.size), dels=dels, up_ids=up_ids,
                              feats=feats, emb=emb, index_staged=index_staged)

    def apply_mutation(self, staged: StagedMutation) -> None:
        """Stage B: tombstone deletes, write the staged upserts, update the
        feature store."""
        if staged.dels is not None:
            self.index.delete(staged.dels)
            self.store.drop(staged.dels)
        if staged.up_ids is not None:
            staged.pending = self.index.begin_upsert(
                staged.up_ids, staged.emb, staged.index_staged)
            self.store.put(staged.up_ids, staged.feats)

    def finish_mutation(self, staged: StagedMutation) -> None:
        """Barrier: after this, the batch is query-visible."""
        if staged.up_ids is not None:
            self.index.finish_upsert(staged.pending)

    def graph_apply(self, staged: StagedMutation) -> None:
        """Maintained-graph update for an applied batch."""
        if self.graph is None:
            return
        if staged.dels is not None:
            self.graph.delete(staged.dels)
        if staged.up_ids is not None:
            res = self._index_neighbors_of_ids(
                staged.up_ids, self.graph.cfg.probe_k(), timed=False)
            self.graph.upsert(staged.up_ids, res)

    def flush_graph_repair(self, limit: int | None = None) -> int:
        """Drain the graph's repair queue: rows left under-full by deletes
        or evictions get a fresh neighborhood merged in (no purge: their
        embeddings did not change). One batched re-query per drain, capped
        at ``limit`` (default ``MaintenanceConfig.repair_per_tick``)."""
        if self.graph is None:
            return 0
        rep = self.graph.take_repair_ids(limit)
        if rep.size:
            self.graph.upsert(
                rep, self._index_neighbors_of_ids(
                    rep, self.graph.cfg.probe_k(), timed=False),
                purge=False)
        return int(rep.size)

    # --------------------------------------------------- neighborhood RPC

    def neighbors(self, features: Mapping[str, np.ndarray],
                  k: int | None = None,
                  exclude_ids: np.ndarray | None = None) -> NeighborResult:
        """Neighborhood of (possibly new) points given their features
        (paper §3.3.3): embed -> ANN search -> score -> respond."""
        with self.query_timer:
            return self._neighbors_impl(features, k, exclude_ids)

    def _neighbors_impl(self, features, k, exclude_ids) -> NeighborResult:
        k = k or self.cfg.scann_nn
        emb = self.embedder(features)
        ids, dists = self.index.search(emb, k + (exclude_ids is not None))
        if exclude_ids is not None:
            ids, dists = _drop_self(ids, dists, np.asarray(exclude_ids), k)
        cand_feats = self.store.gather(ids)
        flat_c = {kk: v.reshape((-1,) + v.shape[2:])
                  for kk, v in cand_feats.items()}
        # each query row is read once for its ids.shape[1] candidates
        weights = score_pairs(self.scorer_params, features, flat_c,
                              self.spec, group=ids.shape[1]).cpu().numpy()
        weights = weights.reshape(ids.shape)
        weights = np.where(ids >= 0, weights, -np.inf)
        return NeighborResult(ids=ids, weights=weights.astype(np.float32),
                              distances=dists)

    def neighbors_of_ids(self, ids: np.ndarray, k: int | None = None
                         ) -> NeighborResult:
        """Neighborhood of existing points (self-match excluded).

        With a maintained graph, requests at k <= the graph's k are served
        straight from the graph rows: no re-embedding, no ANN search. With
        ``staleness_bound > 0`` the read goes through the published
        `GraphView`, which lags the applied stream by at most that many
        batches; ids the graph (or view) does not know yet take the
        embed -> search -> score path."""
        ids = np.asarray(ids)
        k = k or self.cfg.scann_nn
        if self.graph is not None and k <= self.graph.cfg.k:
            if self.maintenance.staleness_bound > 0:
                view = self.graph.view()
                if view.has_ids(ids):
                    with self.query_timer:
                        return view.neighbors_of_ids(ids, k)
            elif self.graph.has_ids(ids):
                with self.query_timer:
                    return self.graph.neighbors_of_ids(ids, k)
        return self._index_neighbors_of_ids(ids, k)

    def _index_neighbors_of_ids(self, ids: np.ndarray, k: int | None = None,
                                timed: bool = True) -> NeighborResult:
        """The embed -> search -> score path, bypassing the graph (graph
        maintenance uses it with ``timed=False``, so its re-queries are
        billed to ``graph_timer``, not to the query timer)."""
        ids = np.asarray(ids)
        feats = self.store.gather(ids)
        if timed:
            return self.neighbors(feats, k, exclude_ids=ids)
        return self._neighbors_impl(feats, k, exclude_ids=ids)


def _drop_self(ids, dists, self_ids, k):
    """Remove each query's own id from its result row, then trim to k."""
    out_ids = np.full((ids.shape[0], k), -1, ids.dtype)
    out_d = np.full((ids.shape[0], k), np.inf, dists.dtype)
    for r in range(ids.shape[0]):
        keep = ids[r] != self_ids[r]
        sel_ids, sel_d = ids[r][keep][:k], dists[r][keep][:k]
        out_ids[r, :sel_ids.size] = sel_ids
        out_d[r, :sel_d.size] = sel_d
    return out_ids, out_d
