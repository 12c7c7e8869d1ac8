"""Dynamic GUS (port of ``repro/core/gus.py``, paper §3): Embedding
Generator + ScaNN-style index + Similarity Scorer behind the two RPC
surfaces, mutations and neighborhoods, plus the offline bootstrap, the
periodic reload, and the maintained graph (``GusConfig.graph``): every
mutation RPC updates the graph, and ``neighbors_of_ids`` at k <= the
graph's k serves straight from its rows.

Backends ``"scann"``, the exact ``"brute"`` and ``"sharded"``
(``ann/sharded_index.py``: the index sharded over ``ShardedConfig.
n_shards`` shards, all driven from this process, with a maintained slab
lifecycle), the multi-modal scoring plane (``GusConfig.multimodal``:
``repro_torch.multimodal``) and the maintenance knobs
(``GusConfig.maintenance``). The write path is split at the encode/apply
boundary (``StagedMutation``) that ``serve.pipeline.MutationPipeline``
double-buffers, and ``snapshot_state`` / ``restore_state`` compose each
subsystem's own (host arrays only) for ``serve.engine``'s snapshot and
recovery. The neighborhood RPC's pair scores go
through the scorer kernel on the card. Per-RPC wall-clock timers mirror
the paper's Figs. 9-10; results are copied to the host inside the timed
block, so each sample covers the device work; graph maintenance is billed
to ``graph_timer``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping

import numpy as np

from repro_torch.ann.brute import BruteIndex
from repro_torch.ann.scann import ScannConfig, ScannIndex
from repro_torch.ann.sharded_index import ShardedConfig, ShardedGusIndex
from repro_torch.core import idf as idf_mod
from repro_torch.core.buckets import BucketConfig
from repro_torch.core.embedding import EmbeddingGenerator
from repro_torch.core.maintenance import MaintenanceConfig
from repro_torch.core.scorer import score_pairs
from repro_torch.core.types import (FeatureSpec, MutationBatch, NeighborResult,
                                    MUTATION_DELETE)
from repro_torch.graph.store import DynamicGraphStore, GraphConfig
from repro_torch.multimodal import (MultiModalConfig, MultiModalStore,
                                    two_stage_neighbors)
from repro_torch.obs import stage
from repro_torch.utils.device import resolve
from repro_torch.utils.timing import Timer


@dataclasses.dataclass
class StagedMutation:
    """A mutation batch split at the encode/apply boundary (the unit the
    pipeline double-buffers). ``encode_mutation`` fills everything but
    ``pending``; ``apply_mutation`` issues the device writes and parks the
    index's barrier handle (a CUDA event on the card) in ``pending``."""
    n: int                                  # points acknowledged
    dels: np.ndarray | None                 # ids to tombstone
    up_ids: np.ndarray | None               # ids to insert/update
    feats: dict | None                      # store-normalized features
    emb: object | None                      # SparseBatch embeddings
    index_staged: object | None             # backend encode artifacts
    buckets: tuple | None = None            # (bucket_ids, valid) np arrays,
                                            # staged when multimodal is on
    pending: object | None = None           # the writes' CUDA event


@dataclasses.dataclass(frozen=True)
class GusConfig:
    scann_nn: int = 10           # ScaNN-NN: neighbors retrieved from the index
    idf_size: int = 0            # IDF-S   : IDF table size (0 = unit weights)
    filter_percent: float = 0.0  # Filter-P: % of most popular buckets dropped
    backend: str = "scann"       # "scann" | "brute" | "sharded"
    scann: ScannConfig = ScannConfig()
    sharded: ShardedConfig = ShardedConfig()
    # maintained-graph layer (repro_torch.graph): None disables maintenance
    graph: GraphConfig | None = None
    # canonical home of the maintenance knobs: when set, it overrides
    # GraphConfig.maintenance and ShardedConfig.maintenance;
    # `staleness_bound > 0` serves published graph versions and activates
    # the concurrent maintenance plane
    maintenance: MaintenanceConfig | None = None
    # multi-modal scoring plane (repro_torch.multimodal): None keeps the
    # dense embed -> search -> score path bitwise unchanged
    multimodal: MultiModalConfig | None = None


def make_index(k_dims: int, cfg: GusConfig, device):
    """ANN backend factory — every backend speaks build/upsert/delete/search."""
    if cfg.backend == "brute":
        return BruteIndex(k_dims, device=device)
    if cfg.backend == "scann":
        return ScannIndex(k_dims, cfg.scann, device)
    if cfg.backend == "sharded":
        return ShardedGusIndex(k_dims, cfg.sharded, device)
    raise ValueError(f"unknown GUS backend {cfg.backend!r}")


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
        """Drop every row (a stale replica re-bootstrapping from a
        snapshot must not keep features the snapshot already dropped)."""
        self._rows.clear()

    def ids(self) -> np.ndarray:
        """Live point ids, ascending."""
        return np.asarray(sorted(self._rows), np.int64)

    def gather(self, ids: np.ndarray) -> dict:
        """Batch features for ids (missing ids get zeros)."""
        ids = np.asarray(ids)
        with stage("gus.gather", rows=int(ids.size)):
            proto = self.spec.feature_shapes(1)
            out = {k: np.zeros((ids.size,) + shape[1:], dtype)
                   for k, (shape, dtype) in proto.items()}
            for j, pid in enumerate(ids.reshape(-1).tolist()):
                row = self._rows.get(pid)
                if row is not None:
                    for k, v in row.items():
                        out[k][j] = v
            return {k: v.reshape(ids.shape + v.shape[1:])
                    for k, v in out.items()}

    def __len__(self):
        return len(self._rows)

    def __contains__(self, pid) -> bool:
        return int(pid) in self._rows

    # --------------------------------------------------------- persistence

    def snapshot_state(self) -> dict:
        ids = self.ids()
        return {"ids": ids, "features": self.gather(ids)}

    def restore_state(self, state: dict) -> None:
        self.clear()
        if len(state["ids"]):
            self.put(state["ids"], state["features"])


class DynamicGUS:
    """The Dynamic Grale Using ScaNN engine, on one device."""

    def __init__(self, spec: FeatureSpec, bucket_cfg: BucketConfig,
                 scorer_params: dict, cfg: GusConfig = GusConfig(),
                 device=None):
        self.device = resolve(device)
        self.spec = spec
        # GusConfig.maintenance is canonical: push it down into the
        # per-subsystem configs so every layer sees one set of knobs
        if cfg.maintenance is not None:
            sub = {"sharded": dataclasses.replace(
                cfg.sharded, maintenance=cfg.maintenance)}
            if cfg.graph is not None:
                sub["graph"] = dataclasses.replace(
                    cfg.graph, maintenance=cfg.maintenance)
            cfg = dataclasses.replace(cfg, **sub)
        self.cfg = cfg
        self.maintenance = (
            cfg.maintenance
            or (cfg.graph.maintenance if cfg.graph is not None else None)
            or (cfg.sharded.maintenance if cfg.backend == "sharded"
                else None)
            or MaintenanceConfig())
        self.embedder = EmbeddingGenerator.create(spec, bucket_cfg,
                                                  self.device)
        self.scorer_params = {k: v.to(self.device)
                              for k, v in scorer_params.items()}
        self.store = FeatureStore(spec)
        self.index = make_index(self.embedder.k_max, cfg, self.device)
        self.graph = (DynamicGraphStore(cfg.graph, self.device)
                      if cfg.graph else None)
        self.multimodal = (MultiModalStore(cfg.multimodal,
                                           device=self.device)
                           if cfg.multimodal is not None else None)
        # applied mutation batches: published graph versions are stamped
        # against this count
        self.seq_applied = 0
        self.mutation_timer = Timer("mutation")
        self.query_timer = Timer("neighbors")
        self.graph_timer = Timer("graph")

    # ----------------------------------------------------- offline (§4.3)

    def bootstrap(self, ids: np.ndarray, features: Mapping[str, np.ndarray],
                  build_graph: bool = True) -> None:
        """Offline preprocessing: compute IDF/filter tables from the initial
        corpus, (re)build the index, and load all points. The multi-modal
        plane (if configured) is seeded next, then the maintained graph
        (if configured) from full-corpus neighborhoods in chunks of 256
        ids, then its repair queue is drained; pass ``build_graph=False``
        when restoring the graph from a snapshot."""
        bucket_ids, valid = self.embedder.buckets(features)
        bucket_ids = bucket_ids.cpu().numpy()
        valid = valid.cpu().numpy()
        n = len(ids)
        self.embedder = self.embedder.reload(
            idf=idf_mod.build_idf_table(bucket_ids, valid, n,
                                        self.cfg.idf_size, self.device),
            filter_table=idf_mod.build_filter_table(
                bucket_ids, valid, self.cfg.filter_percent, self.device))
        emb = self.embedder(features)
        self.index.build(np.asarray(ids), emb)
        self.store.put(ids, features)
        if self.multimodal is not None:
            # before the graph: its candidate stage feeds graph seeding
            self.multimodal.rebuild(ids, emb, bucket_ids, valid)
        self._start_graph(ids, build_graph)

    def _start_graph(self, ids: np.ndarray, build_graph: bool) -> None:
        """``bootstrap``'s graph step: a fresh maintained graph over the
        loaded corpus ``ids``, seeded (when ``build_graph``) from their
        neighborhoods in chunks of 256, then a repair flush."""
        if self.graph is None:
            return
        self.graph = DynamicGraphStore(self.cfg.graph, self.device)
        if build_graph:
            with self.graph_timer:
                self.graph.ensure_ids(np.asarray(ids))
                for lo in range(0, len(ids), 256):
                    chunk = np.asarray(ids[lo:lo + 256])
                    self.graph.upsert(chunk, self._index_neighbors_of_ids(
                        chunk, self.graph.cfg.probe_k(), timed=False))
                self.flush_graph_repair(limit=len(ids))
        if self.maintenance.staleness_bound > 0:
            self.graph.publish(seq=self.seq_applied)

    def periodic_reload(self) -> None:
        """Recompute IDF/filter from the live corpus and retrain the index
        (the paper's periodic consistency refresh)."""
        ids = self.store.ids()
        if ids.size == 0:
            return
        feats = self.store.gather(ids)
        bucket_ids, valid = self.embedder.buckets(feats)
        bucket_ids = bucket_ids.cpu().numpy()
        valid = valid.cpu().numpy()
        self.embedder = self.embedder.reload(
            idf=idf_mod.build_idf_table(bucket_ids, valid, ids.size,
                                        self.cfg.idf_size, self.device),
            filter_table=idf_mod.build_filter_table(
                bucket_ids, valid, self.cfg.filter_percent, self.device))
        # the reloaded tables change the embeddings, so the index retrains
        # (scann) or reloads (brute) from the live corpus
        emb = self.embedder(feats)
        self.index.build(ids, emb)
        if self.multimodal is not None:
            self.multimodal.rebuild(ids, emb, bucket_ids, valid)

    # ------------------------------------------------------ mutation RPCs

    def mutate(self, batch: MutationBatch) -> int:
        """Insert / update / delete a batch of points (paper §3.3.1-.2).
        Returns the number of points acknowledged. With a maintained graph,
        every mutation also updates it (timed apart in ``graph_timer``):
        deletes tombstone the row and purge back-edges; upserts re-query
        the point's scored neighborhood and apply two-sided edge updates;
        then one repair drain."""
        with stage("gus.mutate", rows=lambda: int(np.asarray(batch.ids).size)):
            with self.mutation_timer:
                staged = self.encode_mutation(batch)
                self.apply_mutation(staged)
                self.finish_mutation(staged)
            self.seq_applied += 1
            self.maybe_reload_multimodal()
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
        with stage("mutate.encode"):
            kinds = np.asarray(batch.kinds)
            ids = np.asarray(batch.ids)
            del_mask = kinds == MUTATION_DELETE
            dels = ids[del_mask] if del_mask.any() else None
            up_ids = feats = emb = index_staged = None
            up_mask = ~del_mask
            if up_mask.any():
                up_ids = ids[up_mask]
                proto = self.spec.feature_shapes(1)
                feats = {k: np.asarray(v)[up_mask].astype(proto[k][1],
                                                          copy=False)
                         for k, v in batch.features.items()}
                emb = self.embedder(feats)
                index_staged = self.index.encode_upsert(up_ids, emb)
            buckets = None
            if self.multimodal is not None and feats is not None:
                # a pure function of the features: staging keeps encode pure
                b_ids, b_valid = self.embedder.buckets(feats)
                buckets = (b_ids.cpu().numpy(), b_valid.cpu().numpy())
            return StagedMutation(n=int(ids.size), dels=dels,
                                  up_ids=up_ids, feats=feats, emb=emb,
                                  index_staged=index_staged, buckets=buckets)

    def apply_mutation(self, staged: StagedMutation) -> None:
        """Stage B: tombstone deletes, write the staged upserts, update the
        feature store."""
        with stage("mutate.apply"):
            if staged.dels is not None:
                with stage("index.delete", rows=int(staged.dels.size)):
                    self.index.delete(staged.dels)
                self.store.drop(staged.dels)
                if self.multimodal is not None:
                    self.multimodal.delete(staged.dels)
            if staged.up_ids is not None:
                with stage("index.write", rows=int(staged.up_ids.size)):
                    staged.pending = self.index.begin_upsert(
                        staged.up_ids, staged.emb, staged.index_staged)
                self.store.put(staged.up_ids, staged.feats)
                if self.multimodal is not None:
                    self.multimodal.upsert(staged.up_ids, staged.emb,
                                           *staged.buckets)

    def finish_mutation(self, staged: StagedMutation) -> None:
        """Barrier: after this, the batch is query-visible."""
        if staged.up_ids is not None:
            with stage("mutate.finish"):
                self.index.finish_upsert(staged.pending)

    def graph_apply(self, staged: StagedMutation,
                    reuse_emb: bool = False) -> None:
        """Maintained-graph update for an applied batch. ``reuse_emb=True``
        (the pipelined path) feeds the staged embeddings (and buckets)
        straight into the probe query instead of re-gathering and
        re-embedding from the store: the same result bit for bit (the
        store holds the same feature values), one embed less a batch."""
        if self.graph is None:
            return
        with stage("graph.apply"):
            if staged.dels is not None:
                self.graph.delete(staged.dels)
            if staged.up_ids is not None:
                probe_k = self.graph.cfg.probe_k()
                if reuse_emb:
                    res = self._neighbors_impl(staged.feats, probe_k,
                                               exclude_ids=staged.up_ids,
                                               emb=staged.emb,
                                               buckets=staged.buckets)
                else:
                    res = self._index_neighbors_of_ids(
                        staged.up_ids, probe_k, timed=False)
                self.graph.upsert(staged.up_ids, res)

    def flush_graph_repair(self, limit: int | None = None) -> int:
        """Drain the graph's repair queue: rows left under-full by deletes
        or evictions get a fresh neighborhood merged in (no purge: their
        embeddings did not change). One batched re-query per drain, capped
        at ``limit`` (default ``MaintenanceConfig.repair_per_tick``)."""
        if self.graph is None:
            return 0
        with stage("graph.repair"):
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
        with stage("gus.neighbors", ids=len(next(iter(features.values()))),
                   k=int(k or self.cfg.scann_nn)), self.query_timer:
            return self._neighbors_impl(features, k, exclude_ids)

    def maybe_reload_multimodal(self) -> bool:
        """Reload the multi-modal routing tables when the configured
        cadence divides the applied-batch sequence (called right after
        ``seq_applied`` is bumped)."""
        mm = self.multimodal
        if mm is None or mm.cfg.reload_every <= 0:
            return False
        if self.seq_applied > 0 and \
                self.seq_applied % mm.cfg.reload_every == 0:
            mm.reload()
            return True
        return False

    def _neighbors_impl(self, features, k, exclude_ids,
                        emb=None, buckets=None) -> NeighborResult:
        k = k or self.cfg.scann_nn
        if self.multimodal is not None:
            return two_stage_neighbors(self, features, k, exclude_ids,
                                       emb=emb, buckets=buckets)
        if emb is None:
            emb = self.embedder(features)
        ids, dists = self.index.search(emb, k + (exclude_ids is not None))
        if exclude_ids is not None:
            ids, dists = _drop_self(ids, dists, np.asarray(exclude_ids), k)
        cand_feats = self.store.gather(ids)
        flat_c = {kk: v.reshape((-1,) + v.shape[2:])
                  for kk, v in cand_feats.items()}
        # each query row is read once for its ids.shape[1] candidates
        weights = score_pairs(self.scorer_params, features, flat_c,
                              self.spec, group=ids.shape[1])
        with stage("score.to_host"):
            weights = weights.cpu().numpy()
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
        with stage("gus.neighbors", ids=int(ids.size), k=int(k)):
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
        billed to ``graph_timer``, not to the query timer). The query
        timer covers the gather of the query rows."""
        ids = np.asarray(ids)
        with self.query_timer if timed else contextlib.nullcontext():
            return self._neighbors_impl(self.store.gather(ids), k,
                                        exclude_ids=ids)

    # --------------------------------------------------------- persistence

    def snapshot_state(self) -> dict:
        """Composed snapshot, host arrays only: the feature store (the
        corpus of record), the index's routing state, the full graph state
        and the multi-modal plane, each from the subsystem's own
        ``snapshot_state``."""
        return {
            "store": self.store.snapshot_state(),
            "index": self.index.snapshot_state(),
            "graph": (self.graph.snapshot_state()
                      if self.graph is not None else None),
            "multimodal": (self.multimodal.snapshot_state()
                           if self.multimodal is not None else None),
        }

    def restore_state(self, state: dict) -> None:
        """Inverse composition. The index's routing state installs before
        ``bootstrap`` rebuilds it, and the graph restores after the corpus
        exists (a snapshotted graph skips the bootstrap re-seed)."""
        self.store.clear()
        self.index.restore_state(state.get("index") or {})
        graph_state = state.get("graph")
        st = state["store"]
        self.bootstrap(st["ids"], st["features"],
                       build_graph=graph_state is None)
        if self.graph is not None and graph_state is not None:
            self.graph.restore_state(graph_state)
        mm_state = state.get("multimodal")
        if self.multimodal is not None and mm_state is not None:
            # overwrite bootstrap's re-seed: posting-list membership
            # depends on insertion order (capped lists), so the restored
            # plane must be the snapshotted one, not a rebuild
            self.multimodal.restore_state(mm_state)


def _drop_self(ids, dists, self_ids, k):
    """Remove each query's own id from its result row, then trim to k."""
    with stage("gus.drop_self", rows=int(ids.shape[0])):
        out_ids = np.full((ids.shape[0], k), -1, ids.dtype)
        out_d = np.full((ids.shape[0], k), np.inf, dists.dtype)
        for r in range(ids.shape[0]):
            keep = ids[r] != self_ids[r]
            sel_ids, sel_d = ids[r][keep][:k], dists[r][keep][:k]
            out_ids[r, :sel_ids.size] = sel_ids
            out_d[r, :sel_d.size] = sel_d
        return out_ids, out_d
