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
    """Host-side feature store keyed by point id: one numpy column per
    feature key, ``[capacity + 1, *shape]`` in the spec's dtype.

    A live point owns one slot (row) of every column. Capacity grows
    geometrically and ``drop`` returns slots to a free list. The last row
    of every column is never written, so slot -1, which stands for an
    absent id, gathers zeros. Ids map to slots through a dense table
    indexed by id (-1 absent) while every id the store has taken is
    non-negative and below ``_DENSE_SPAN`` times the capacity; any other
    id turns the store to sorted keys searched with ``np.searchsorted``
    until ``clear``, so the map never grows with the largest id."""

    _DENSE_SPAN = 4
    _MIN_CAPACITY = 1024

    def __init__(self, spec: FeatureSpec):
        self.spec = spec
        self._shapes = {k: (shape[1:], dtype) for k, (shape, dtype)
                        in spec.feature_shapes(1).items()}
        self.clear()

    @property
    def _capacity(self) -> int:
        return len(next(iter(self._cols.values()))) - 1

    @property
    def dense(self) -> bool:
        """Whether the dense id table serves lookups (else sorted keys)."""
        return self._table is not None

    def put(self, ids: np.ndarray, features: Mapping[str, np.ndarray]) -> None:
        """Store each id's row; an id repeated in ``ids`` keeps its last
        row, a live id is overwritten in its own slot, and a key the batch
        lacks reads back as zeros."""
        unknown = set(features) - set(self._shapes)
        if unknown:
            raise ValueError(f"feature keys not in the spec: {sorted(unknown)}")
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return
        uniq, first_rev = np.unique(ids[::-1], return_index=True)
        rows = ids.size - 1 - first_rev
        slots = self._lookup(uniq)
        new = slots < 0
        if new.any():
            slots[new] = self._take_slots(int(np.count_nonzero(new)))
            self._map(uniq[new], slots[new])
        for k, col in self._cols.items():
            col[slots] = np.asarray(features[k])[rows] if k in features else 0

    def drop(self, ids) -> None:
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
        slots = self._lookup(ids)
        hit = slots >= 0
        ids, slots = ids[hit], slots[hit]
        if not ids.size:
            return
        if self._table is not None:
            self._table[ids] = -1
        else:
            pos = np.searchsorted(self._keys, ids)
            self._keys = np.delete(self._keys, pos)
            self._key_slots = np.delete(self._key_slots, pos)
        self._free = np.concatenate([self._free, slots])

    def clear(self) -> None:
        """Drop every row (a stale replica re-bootstrapping from a
        snapshot must not keep features the snapshot already dropped)."""
        self._cols = {k: np.zeros((1,) + shape, dtype)
                      for k, (shape, dtype) in self._shapes.items()}
        self._top = 0                       # slots ever handed out
        self._free = np.empty(0, np.int64)
        self._table = np.full(1, -1, np.int64)  # id -> slot, then a -1
        self._keys = self._key_slots = None     # the sparse map, sorted

    def ids(self) -> np.ndarray:
        """Live point ids, ascending."""
        if self._table is not None:
            return np.flatnonzero(self._table >= 0).astype(np.int64)
        return self._keys.copy()

    def gather(self, ids: np.ndarray) -> dict:
        """Batch features for ids (missing ids get zeros)."""
        ids = np.asarray(ids)
        flat = ids.reshape(-1).astype(np.int64, copy=False)
        with stage("gus.gather", rows=int(ids.size),
                   missing=lambda: int(np.count_nonzero(
                       self._lookup(flat) < 0)),
                   dense=lambda: self.dense):
            slots = self._lookup(flat)
            return {k: col.take(slots, axis=0).reshape(ids.shape
                                                       + col.shape[1:])
                    for k, col in self._cols.items()}

    def __len__(self):
        return self._top - self._free.size

    def __contains__(self, pid) -> bool:
        return bool(self._lookup(np.asarray([int(pid)], np.int64))[0] >= 0)

    def _lookup(self, ids: np.ndarray) -> np.ndarray:
        """Slots of int64 ids, -1 where absent."""
        if self._table is not None:
            # ids outside [0, L) land on the table's trailing -1
            return self._table[np.clip(ids, -1, self._table.size - 1)]
        if not self._keys.size:
            return np.full(ids.shape, -1, np.int64)
        pos = np.minimum(np.searchsorted(self._keys, ids), self._keys.size - 1)
        return np.where(self._keys[pos] == ids, self._key_slots[pos], -1)

    def _take_slots(self, n: int) -> np.ndarray:
        """``n`` free slots: from the free list first, then fresh ones."""
        reuse = min(n, self._free.size)
        got = self._free[self._free.size - reuse:]
        self._free = self._free[:self._free.size - reuse]
        fresh = n - reuse
        if fresh:
            top = self._top + fresh
            if top > self._capacity:
                self._grow(max(top, 2 * self._capacity, self._MIN_CAPACITY))
            got = np.concatenate([got, np.arange(self._top, top)])
            self._top = top
        return got

    def _grow(self, capacity: int) -> None:
        for k, col in self._cols.items():
            grown = np.zeros((capacity + 1,) + col.shape[1:], col.dtype)
            grown[:self._top] = col[:self._top]
            self._cols[k] = grown

    def _map(self, ids: np.ndarray, slots: np.ndarray) -> None:
        """Enter new ids (ascending, absent) at their slots."""
        if self._table is not None:
            span = self._DENSE_SPAN * max(self._capacity, self._MIN_CAPACITY)
            if ids[0] >= 0 and ids[-1] < span:
                n = self._table.size - 1
                if ids[-1] >= n:
                    table = np.full(min(max(int(ids[-1]) + 1, 2 * n), span)
                                    + 1, -1, np.int64)
                    table[:n] = self._table[:n]
                    self._table = table
                self._table[ids] = slots
                return
            live = np.flatnonzero(self._table >= 0)
            self._keys, self._key_slots = live, self._table[live]
            self._table = None
        pos = np.searchsorted(self._keys, ids)
        self._keys = np.insert(self._keys, pos, ids)
        self._key_slots = np.insert(self._key_slots, pos, slots)

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
    """Remove each query's own id from its result row (every occurrence),
    keep the rest in order, then trim to k; short rows pad with -1 / inf."""
    with stage("gus.drop_self", rows=int(ids.shape[0])):
        out_ids = np.full((ids.shape[0], k), -1, ids.dtype)
        out_d = np.full((ids.shape[0], k), np.inf, dists.dtype)
        keep = ids != np.asarray(self_ids).reshape(-1, 1)
        col = np.cumsum(keep, axis=1) - 1      # each kept entry's column
        keep &= col < k
        at = np.nonzero(keep)[0], col[keep]
        out_ids[at] = ids[keep]
        out_d[at] = dists[keep]
        return out_ids, out_d
