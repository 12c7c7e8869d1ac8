"""Live sharded GUS backend (port of ``repro/ann/sharded_index.py``): the
programs of ``ann/sharded.py`` behind the index protocol.

``ShardedGusIndex`` runs the sharded query / mutate / delete / compact
programs over a ``launch.mesh.GusMesh`` (one device per shard; on one card
every shard shares it) behind the same ``build / upsert / delete /
search`` protocol as ``BruteIndex`` and ``ScannIndex``, so ``DynamicGUS``
serves from it unchanged (``GusConfig(backend="sharded")``).

Serving dataflow (paper §3.1 mapped onto shards):

  mutate  — rows hash-route to their owner shard (salted hash — see
            re-split below) and append ring-buffer style into the nearest
            local partition's slab and, with SOAR (the default), into a
            secondary local partition. The step returns each row's landing
            sites (global partition, slot) per copy, which the host
            mirrors into an id -> rows map (needed for deletes and result
            translation).
  delete  — the host looks up landing sites; the tombstone program clears
            the validity bits on the owning shard.
  search  — per shard: centroid matmul -> local top-nprobe -> fused PQ
            shortlist with SOAR dedup -> exact sparse rescore -> local
            top-k; one gather + merge top-k across shards. The host
            translates global rows back to point ids.

Slab lifecycle (capacity is maintained, not silently recycled):

  compaction — ``compact()`` squeezes dead slots (tombstones, superseded
            copies) out, live rows slide forward in stable order, the ring
            cursor resets to the live count, and the host id -> rows map
            is remapped from the device's old-slot -> new-slot map. Search
            results are bit-identical before and after. With
            ``maintenance.compact`` (default), ``begin_upsert`` compacts
            before a chunk would wrap a slab and, if live occupancy alone
            would still overflow, doubles the slab, so live rows never age
            out (``aged_out`` counts the rows a wrap dropped; it stays 0).
  re-split — ``resplit()`` fixes per-shard skew: when ``max/mean`` live
            rows (or queries served) per shard exceeds the threshold, the
            hottest shard's rows are read back, the owner-hash ``salt`` is
            bumped, and the rows re-insert through the ordinary
            route/mutate path. Queries never consult the owner hash, so
            mixed-salt placements stay exactly servable; ``GusEngine``
            snapshots the salt so recovery re-routes the same way.

Fuse-window rule (the compaction boundary, ``serve/pipeline.py``):
compaction and slab growth move slots, so they run only inside
``begin_upsert``, after the current call's pending landing sites are
materialized. ``maintenance_pressure()`` tells the pipeline when a wrap is
possible: at staleness bound 0 it closes its fuse window then, which
keeps the pipelined schedule bit-identical to the synchronous one. Every
lifecycle step builds its successor state fully before one reference
swap and bumps ``version``; ``publish()`` names the current state as an
immutable ``IndexVersion``. The in-place mutate and delete steps copy the
shard tensors first when a published version holds them, so a holder
never sees a later write.

The write barrier is the batch's CUDA event (``utils/device.py::
record_writes``): ``finish_upsert`` waits for this batch's writes, not
for the device.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.ann import partition as part_mod
from repro_torch.ann import quantize as pq
from repro_torch.ann.sharded import (MUTABLE, PAD_ID, ROW_PAD, GusCellConfig,
                                     global_array, make_compact_step,
                                     make_delete_step, make_mutate_step,
                                     make_query_step)
from repro_torch.ann.sparse import count_sketch
from repro_torch.core import hashing
from repro_torch.core.maintenance import MaintenanceConfig
from repro_torch.core.types import PAD_INDEX, SparseBatch
from repro_torch.launch.mesh import make_gus_mesh
from repro_torch.obs import Telemetry
from repro_torch.utils.device import record_writes


@dataclasses.dataclass(frozen=True)
class IndexVersion:
    """An immutable published version of the slabs (the RCU read side).

    ``state`` holds the shard tensors by reference (the index copies them
    before its next in-place write, and every other lifecycle step builds
    new ones); ``id_of_row`` is copied because ``_materialize`` writes it
    in place. A holder keeps a self-consistent translated view across
    later writes, compactions, grows and re-splits."""

    version: int
    seq: int                      # last applied mutation batch reflected
    state: list
    id_of_row: np.ndarray
    salt: int
    slab: int
    points: int


@dataclasses.dataclass(frozen=True)
class ShardedConfig:
    n_shards: int = 1
    d_proj: int = 64            # CountSketch dimension
    n_partitions: int = 16      # global partition count (divisible by shards)
    slab: int = 512             # ring-buffer rows per partition (minimum;
    #                             build() grows it to fit the corpus)
    nprobe_local: int = 0       # partitions probed per shard (0 = all local)
    reorder: int = 256          # per-shard exact-rescore shortlist
    query_batch: int = 64       # queries per step call
    mutate_batch: int = 256     # rows per mutate step call
    pq_m: int = 8               # PQ subspaces
    pq_centers: int = 256
    kmeans_iters: int = 12
    pq_iters: int = 6
    eta: float = 1.0            # anisotropic weight for codebook training
    seed: int = 13
    merge: str = "flat"         # cross-shard candidate merge: "flat" | "hier"
    fused: bool = True          # fused shortlist op (False = composed ops,
    #                             bitwise-identical)
    pq_int8: bool = False       # int8-quantised LUT scoring in the shortlist
    # replica group: its shards' placement (launch.mesh.make_gus_mesh)
    pod: int = 0
    # lifecycle knobs: SOAR weight, auto-compaction, slab headroom, skew
    # re-splits
    maintenance: MaintenanceConfig = MaintenanceConfig()

    @property
    def use_soar(self) -> bool:
        # SOAR disabled when a shard owns a single partition: no distinct
        # secondary exists
        return (self.maintenance.soar >= 0
                and self.n_partitions // max(self.n_shards, 1) > 1)

    @property
    def n_copies(self) -> int:
        return 2 if self.use_soar else 1


class ShardedGusIndex:
    """Dynamic sharded index over sparse embeddings."""

    def __init__(self, k_dims: int, cfg: ShardedConfig = ShardedConfig(),
                 device=None):
        if cfg.n_partitions % cfg.n_shards:
            raise ValueError(
                f"n_partitions={cfg.n_partitions} must be divisible by "
                f"n_shards={cfg.n_shards}")
        if cfg.d_proj % cfg.pq_m:
            raise ValueError(
                f"d_proj={cfg.d_proj} must split into pq_m={cfg.pq_m} "
                "subspaces")
        self.k_dims = k_dims
        self.cfg = cfg
        self.mesh = make_gus_mesh(cfg.n_shards,
                                  two_level=cfg.merge == "hier",
                                  pod=cfg.pod, device=device)
        # the host-side work (sketch, routing mirror, codes, merge) runs on
        # shard 0's device
        self.device = self.mesh.devices[0]
        self.trained = False
        self.slab = cfg.slab
        self.salt = 3                        # owner-hash salt (resplit bumps)
        self.state: list[dict] | None = None
        self.centroids: torch.Tensor | None = None
        self.books: torch.Tensor | None = None
        # id -> landing rows (part*S + pos), one per copy, primary first
        self.row_of: dict[int, tuple[int, ...]] = {}
        self.id_of_row: np.ndarray | None = None
        self._cursor = np.zeros((cfg.n_partitions,), np.int64)  # appends/part
        # queries served per partition since the last load-driven
        # re-split (the "load" skew metric; search() accumulates hits)
        self.query_load = np.zeros((cfg.n_partitions,), np.int64)
        self._query_steps: dict = {}         # k -> query step
        self._mutate = None
        self._tombstone = None
        self._compact_step = None
        self._in_maintenance = False
        # a published IndexVersion holds the current shard tensors: the
        # next in-place write copies them first
        self._shared = False
        # versioned publishing: every lifecycle step that re-homes slots
        # (compaction, slab grow, re-split) builds its successor state
        # fully before the reference swap, then bumps `version`
        self.version = 0
        self._published: IndexVersion | None = None
        # lifecycle counters (occupancy() surfaces them)
        self.compactions = 0
        self.slab_grows = 0
        self.resplits = 0
        self.reclaimed = 0                   # dead slots squeezed out
        self.compacted_rows = 0              # live rows moved by compactions
        self.compact_s = 0.0                 # wall-clock spent compacting
        self.aged_out = 0                    # ids lost to ring wrap (0 when
        #                                      maintenance.compact is on)
        # standalone indexes get a private telemetry plane; an engine
        # rebinds its primary's index into the shared one (bind_telemetry)
        self.obs = Telemetry()
        self._bind_instruments()

    def _bind_instruments(self) -> None:
        reg = self.obs.registry
        self._c_compactions = reg.counter(
            "index_compactions_total", "slab compactions run")
        self._c_reclaimed = reg.counter(
            "index_reclaimed_slots_total", "dead slots squeezed out")
        self._c_compacted_rows = reg.counter(
            "index_compacted_rows_total", "live rows moved by compactions")
        self._c_slab_grows = reg.counter(
            "index_slab_grows_total", "slab doublings")
        self._c_resplits = reg.counter(
            "index_resplits_total", "skew re-splits")
        self._c_moved_points = reg.counter(
            "index_moved_points_total", "points re-hashed by re-splits")
        self._c_aged_out = reg.counter(
            "index_aged_out_total", "ids lost to ring wrap")
        self._h_compact = reg.histogram(
            "index_compact_ms", "wall-clock per compaction")
        self._h_search = reg.histogram(
            "index_search_ms", "device fan-out/merge time per search call")
        # carry lifetime counts already accumulated into the new registry
        self._c_compactions.inc(self.compactions)
        self._c_reclaimed.inc(self.reclaimed)
        self._c_compacted_rows.inc(self.compacted_rows)
        self._c_slab_grows.inc(self.slab_grows)
        self._c_resplits.inc(self.resplits)
        self._c_aged_out.inc(self.aged_out)

    def bind_telemetry(self, telemetry: Telemetry) -> None:
        """Join a shared telemetry plane (the engine binds its primary's
        index so the slab-lifecycle instruments export through the
        plane's registry; lifetime counts so far transfer over)."""
        self.obs = telemetry
        self._bind_instruments()

    def __len__(self) -> int:
        return len(self.row_of)

    # ------------------------------------------------------------- plumbing

    def _cell(self, top_k: int | None = None) -> GusCellConfig:
        cfg = self.cfg
        c_loc = cfg.n_partitions // cfg.n_shards
        npl = min(cfg.nprobe_local or c_loc, c_loc)
        return GusCellConfig(
            name="gus_live", n_rows=cfg.n_partitions * self.slab,
            k_dims=self.k_dims, d_proj=cfg.d_proj, pq_m=cfg.pq_m,
            pq_centers=cfg.pq_centers, n_partitions=cfg.n_partitions,
            slab=self.slab, nprobe_local=npl, query_batch=cfg.query_batch,
            mutate_batch=cfg.mutate_batch, top_k=top_k or 10,
            reorder=cfg.reorder, merge=cfg.merge,
            soar_lambda=cfg.maintenance.soar if cfg.use_soar else -1.0,
            fused=cfg.fused, pq_int8=cfg.pq_int8)

    def _sketch(self, emb: SparseBatch) -> torch.Tensor:
        return count_sketch(emb, self.cfg.d_proj, self.cfg.seed) \
            .to(self.device)

    def _owners(self, ids: torch.Tensor) -> torch.Tensor:
        """Hash routing, identical to the mutate step's (same salt)."""
        return hashing.uhash(self.salt, ids) % self.cfg.n_shards

    def _route_partitions(self, sk: torch.Tensor, owners: torch.Tensor):
        """Mirror of the mutate step's placement (primary + SOAR secondary
        inside the owner shard's local centroid block): the same function
        (``ann.partition.assign_block``) on the same tensors (the shard
        states hold slices of ``self.centroids``, and each mutate chunk's
        sketch is the one routed here), so on one device the two agree bit
        for bit. It picks the residuals the PQ codes encode; placements
        come back from the step as ground truth. Returns ``(p1, p2)``;
        ``p2`` is None with SOAR disabled."""
        cfg = self.cfg
        p1, p2 = part_mod.assign_partitions_local(
            sk, self.centroids, owners,
            c_loc=cfg.n_partitions // cfg.n_shards,
            soar_lambda=cfg.maintenance.soar if cfg.use_soar else -1.0)
        return p1, (p2 if cfg.use_soar else None)

    def _query_step(self, k: int):
        if k not in self._query_steps:
            self._query_steps[k] = make_query_step(self.mesh,
                                                   self._cell(top_k=k))
        return self._query_steps[k]

    def _new_steps(self) -> None:
        cell = self._cell()
        self._query_steps = {}
        self._mutate = make_mutate_step(self.mesh, cell, self.salt)
        self._tombstone = make_delete_step(self.mesh, cell)
        self._compact_step = make_compact_step(self.mesh, cell)

    def _writable(self) -> list[dict]:
        """The shard states, copied first if a published version holds
        them (the mutate and delete steps write in place)."""
        if self._shared:
            self.state = [{k: (v.clone() if k in MUTABLE else v)
                           for k, v in st.items()} for st in self.state]
            self._shared = False
        return self.state

    def array(self, key: str) -> np.ndarray:
        """One index array over all shards (``[C, ...]``, linear shard
        order) on the host; row ids as uint32."""
        a = global_array(self.state, key).numpy()
        return a.astype(np.uint32) if key == "row_ids" else a

    # ------------------------------------------------------------- training

    def build(self, ids: np.ndarray, emb: SparseBatch) -> None:
        """(Re)train partitions + codebooks on the corpus, reset the slabs,
        then load every point through the mutation path (paper §4.3)."""
        cfg = self.cfg
        ids = np.asarray(ids, np.int64)
        n = len(ids)
        sk = self._sketch(emb)
        self.centroids = part_mod.kmeans(sk, cfg.n_partitions,
                                         cfg.kmeans_iters, cfg.eta, cfg.seed)
        # residuals w.r.t. the routed assignment (owner-local nearest
        # partition): the geometry the codes will live in
        if n:
            p1, _ = self._route_partitions(
                sk, self._owners(torch.as_tensor(ids, device=self.device)))
            residuals = sk - self.centroids[p1]
        else:
            residuals = torch.zeros((1, cfg.d_proj), dtype=torch.float32,
                                    device=self.device)
        books = pq.train_codebooks(residuals, cfg.pq_m, cfg.pq_centers,
                                   cfg.pq_iters, cfg.eta, cfg.seed)
        # size the ring buffers to the bootstrap corpus (every point lands
        # n_copies times) with headroom for churn
        slab = 64
        while slab * cfg.n_partitions < \
                cfg.maintenance.headroom * cfg.n_copies * max(n, 1):
            slab *= 2
        self.slab = max(cfg.slab, slab)
        self._alloc(self.centroids, books)
        self.trained = True
        self.upsert(ids, emb)

    @classmethod
    def from_trained(cls, k_dims: int, cfg: ShardedConfig, centroids, books,
                     slab: int, device=None) -> "ShardedGusIndex":
        """An EMPTY index from offline-trained structures (the counterpart
        of ``ScannIndex.from_trained``) at slab size ``slab``: every point
        then arrives through the mutation path."""
        idx = cls(k_dims, cfg, device)
        idx.slab = int(slab)
        idx._alloc(torch.tensor(np.asarray(centroids, np.float32)),
                   torch.tensor(np.asarray(books, np.float32)))
        idx.trained = True
        return idx

    def _alloc(self, centroids, books) -> None:
        cfg = self.cfg
        c, s = cfg.n_partitions, self.slab
        c_loc = c // cfg.n_shards
        self.centroids = centroids.to(self.device, torch.float32)
        self.books = books.to(self.device, torch.float32)
        self.state = []
        for i, dev in enumerate(self.mesh.devices):
            lo = i * c_loc
            self.state.append({
                # a slice of self.centroids on its device: the routing
                # mirror's GEMM runs on the very same tensor
                "centroids": self.centroids[lo:lo + c_loc].to(dev),
                "books": self.books.to(dev),
                "members_idx": torch.full((c_loc, s, self.k_dims), PAD_INDEX,
                                          dtype=torch.int64, device=dev),
                "members_val": torch.zeros((c_loc, s, self.k_dims),
                                           dtype=torch.float32, device=dev),
                "codes": torch.zeros((c_loc, s, cfg.pq_m), dtype=torch.uint8,
                                     device=dev),
                "row_ids": torch.full((c_loc, s), ROW_PAD, dtype=torch.int32,
                                      device=dev),
                "valid": torch.zeros((c_loc, s), dtype=torch.bool,
                                     device=dev),
                "counts": torch.zeros((c_loc,), dtype=torch.int32,
                                      device=dev)})
        self._shared = False
        self.row_of = {}
        self.id_of_row = np.full((c * s,), -1, np.int64)
        self._cursor = np.zeros((c,), np.int64)
        self.query_load = np.zeros((c,), np.int64)
        self._new_steps()

    # ------------------------------------------------------------ mutations

    def upsert(self, ids: np.ndarray, emb: SparseBatch) -> None:
        self.auto_resplit()
        self.finish_upsert(
            self.begin_upsert(ids, emb, self.encode_upsert(ids, emb)))

    @property
    def auto_resplit_on(self) -> bool:
        """Whether the skew re-split policy is armed. The pipeline pins its
        fuse window to 1 while this holds and calls ``auto_resplit`` on the
        synchronous per-batch schedule."""
        return self.cfg.maintenance.resplit > 0

    def auto_resplit(self) -> int:
        """Policy trigger: re-split when the configured per-shard imbalance
        is exceeded. Runs before a batch's encode: the salt it may bump is
        baked into staged routing, so it must never fire between a batch's
        encode and its append (``serve.pipeline`` calls it only at window
        boundaries, after the previous hand-off)."""
        if self.auto_resplit_on and self.trained:
            return self.resplit(self.cfg.maintenance.resplit)
        return 0

    # Two-phase mutate entry points (serve.pipeline double-buffers them):
    # ``encode_upsert`` reads only build-time structures (centroids, books,
    # salt); ``begin_upsert`` dispatches the appends; ``finish_upsert``
    # folds the landing sites into the host id -> rows map and waits for
    # the batch's writes. ``upsert`` is the composition.

    def encode_upsert(self, ids: np.ndarray, emb: SparseBatch
                      ) -> dict | None:
        """Stage A: dedup, hash-route owners, sketch, partition routing
        (primary + SOAR secondary) per mutate chunk, residual PQ codes per
        copy (all pure)."""
        if not self.trained:
            raise RuntimeError("build() the index before mutating it")
        cfg = self.cfg
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return None
        if int(ids.max()) >= PAD_ID or int(ids.min()) < 0:
            raise ValueError("point ids must fit uint32 below 0xFFFFFFFF "
                             "(hash routing)")
        # within-batch dedup: last write wins (ScannIndex's semantics)
        last = {int(pid): i for i, pid in enumerate(ids.tolist())}
        if len(last) < len(ids):
            keep = np.asarray(sorted(last.values()), np.int64)
            ids, emb = ids[keep], emb[keep]
        dev = self.device
        sk = self._sketch(emb)
        ids_t = torch.as_tensor(ids, device=dev)
        chunks = []
        for lo in range(0, len(ids), cfg.mutate_batch):
            hi = min(lo + cfg.mutate_batch, len(ids))
            b_ids, b_sk = ids_t[lo:hi], sk[lo:hi]
            # routed per chunk: the mutate step sees this very sketch
            p1, p2 = self._route_partitions(b_sk, self._owners(b_ids))
            codes = pq.encode(b_sk - self.centroids[p1], self.books)
            codes2 = (None if p2 is None
                      else pq.encode(b_sk - self.centroids[p2], self.books))
            chunks.append(dict(
                ids=ids[lo:hi].tolist(), ids_t=b_ids,
                idx=emb.indices[lo:hi].to(dev), val=emb.values[lo:hi].to(dev),
                sk=b_sk, codes=codes, codes2=codes2,
                p1=p1.cpu().numpy(),
                p2=None if p2 is None else p2.cpu().numpy()))
        return {"ids": ids, "chunks": chunks}

    def begin_upsert(self, ids: np.ndarray, emb: SparseBatch,
                     staged: dict | None = None):
        """Stage B dispatch: tombstone overwritten rows, ship the staged
        chunks through the mutate step. Returns the pending landing sites
        and the batch's write event.

        This is also where the slab lifecycle runs (the compaction
        boundary): before dispatching a chunk that would wrap a slab, the
        landing sites already dispatched are materialized, the slabs
        compact and, only if live occupancy alone still would not fit, the
        slab doubles. Compaction runs nowhere else, so a pipeline that
        closes its fuse window under ``maintenance_pressure`` keeps the
        pipelined and synchronous schedules bit-identical."""
        if not self.trained:
            raise RuntimeError("build() the index before mutating it")
        if staged is None:
            staged = self.encode_upsert(ids, emb)
        if staged is None:
            return None
        self.delete([pid for pid in staged["ids"].tolist()
                     if pid in self.row_of])
        cfg = self.cfg
        pending = []
        for ch in staged["chunks"]:
            inc = np.bincount(ch["p1"], minlength=cfg.n_partitions)
            if ch["p2"] is not None:
                inc += np.bincount(ch["p2"], minlength=cfg.n_partitions)
            if cfg.maintenance.compact and \
                    np.any(self._cursor + inc > self.slab):
                self._materialize(pending)
                self.compact()
                while np.any(self._live_per_partition() + inc > self.slab):
                    self._grow_slab()
            self.state, (r_part, r_pos) = self._mutate(
                ch["ids_t"], ch["idx"], ch["val"], ch["sk"], ch["codes"],
                self._writable(), new_codes2=ch["codes2"])
            self._cursor += inc
            pending.append((len(ch["ids"]), ch["ids"], r_part, r_pos, inc))
        return {"chunks": pending, "event": record_writes(self.device)}

    def _materialize(self, pending: list) -> None:
        """Fold device-reported landing sites into the host id -> rows map,
        consuming ``pending`` in place. A ring overwrite (only possible
        with ``maintenance.compact`` off) ages the overwritten id out: its
        surviving copies are tombstoned so no stale slot can serve."""
        if not pending:
            return
        stale: list[int] = []
        while pending:
            n_c, chunk_ids, r_part, r_pos, host_inc = pending.pop(0)
            r_part = r_part.cpu().numpy()[:n_c]
            r_pos = r_pos.cpu().numpy()[:n_c]
            # the landing sites are the device truth: resync the cursor
            # mirror should the routing mirror have disagreed
            dev_inc = np.bincount(r_part.reshape(-1),
                                  minlength=self.cfg.n_partitions)
            self._cursor += dev_inc - host_inc
            rows = r_part * self.slab + r_pos          # [n_c, n_copies]
            for pid, rowvec in zip(chunk_ids, rows.tolist()):
                for row in rowvec:
                    old = int(self.id_of_row[row])
                    if old >= 0 and old != pid:
                        self.aged_out += 1             # ring buffer wrapped
                        self._c_aged_out.inc()
                        for other in self.row_of.pop(old, ()):
                            if other != row:
                                self.id_of_row[other] = -1
                                stale.append(other)
                for row in rowvec:
                    self.id_of_row[row] = pid
                self.row_of[pid] = tuple(rowvec)
        # only slots not re-assigned by a later chunk need the tombstone
        stale = [r for r in set(stale) if self.id_of_row[r] < 0]
        if stale:
            self._tombstone_rows(stale)

    def finish_upsert(self, pending=None) -> None:
        """Barrier: materialize the landing sites into the host id -> rows
        map, then wait for the batch's writes (the event ``begin_upsert``
        recorded after them; the acknowledgement of a mutation RPC means
        they are done)."""
        if pending is None:
            return
        self._materialize(pending["chunks"])
        if pending["event"] is not None:
            pending["event"].synchronize()

    def _tombstone_rows(self, rows: list) -> None:
        """Clear validity at global rows."""
        rows_t = torch.as_tensor(np.asarray(rows, np.int64),
                                 device=self.device)
        self.state = self._tombstone(rows_t // self.slab, rows_t % self.slab,
                                     self._writable())

    def delete(self, ids) -> int:
        if not self.trained:
            raise RuntimeError("build() the index before mutating it")
        rows = []
        n_del = 0
        for pid in list(ids):
            rowvec = self.row_of.pop(int(pid), None)
            if rowvec is None:
                continue
            n_del += 1
            for row in rowvec:
                rows.append(row)
                self.id_of_row[row] = -1
        if rows:
            self._tombstone_rows(rows)
        return n_del

    # ------------------------------------------------------ slab lifecycle

    def _live_per_partition(self) -> np.ndarray:
        """Live copies per partition, from the host id -> rows map."""
        c = self.cfg.n_partitions
        if not self.row_of:
            return np.zeros((c,), np.int64)
        rows = np.fromiter((r for t in self.row_of.values() for r in t),
                           np.int64)
        return np.bincount(rows // self.slab, minlength=c)

    def compact(self) -> dict:
        """Squeeze tombstoned / superseded slots out of every slab.

        Live rows keep their relative order (the compact program is
        stable), so unchanged queries return bit-identical results; the
        ring cursors restart at the live counts and the host id -> rows
        map is remapped from the device's slot map. Callers driving the
        async write path flush it first: compaction moves slots, and
        in-flight landing sites name the old layout (``begin_upsert``'s
        trigger materializes its own pending sites before compacting)."""
        if not self.trained:
            raise RuntimeError("build() the index before compacting it")
        t0 = time.perf_counter()
        new_state, new_pos = self._compact_step(self.state)
        new_pos = new_pos.cpu().numpy()
        occupied = int(np.minimum(self._cursor, self.slab).sum())
        s = self.slab
        new_id_of_row = np.full_like(self.id_of_row, -1)
        if self.row_of:
            # vectorized remap: n_copies is uniform across the index, so
            # the id -> rows map flattens to one [points, copies] gather
            pids = np.fromiter(self.row_of.keys(), np.int64,
                               len(self.row_of))
            old_rows = np.asarray(list(self.row_of.values()), np.int64)
            parts, poss = np.divmod(old_rows, s)
            new_rows = parts * s + new_pos[parts, poss]
            new_row_of = {int(p): tuple(r) for p, r in
                          zip(pids.tolist(), new_rows.tolist())}
            new_id_of_row[new_rows.reshape(-1)] = np.repeat(
                pids, new_rows.shape[1])
            live = np.bincount(new_rows.reshape(-1) // s,
                               minlength=self.cfg.n_partitions)
        else:
            new_row_of = {}
            live = np.zeros((self.cfg.n_partitions,), np.int64)
        # the successor version is fully built: swap every piece at once
        self.state = new_state
        self._shared = False
        self.row_of = new_row_of
        self.id_of_row = new_id_of_row
        self._cursor = live.astype(np.int64)
        self.version += 1
        n_live = int(live.sum())
        reclaimed = max(occupied - n_live, 0)
        dt = time.perf_counter() - t0
        self.compactions += 1
        self.compacted_rows += n_live
        self.reclaimed += reclaimed
        self.compact_s += dt
        self._c_compactions.inc()
        self._c_compacted_rows.inc(n_live)
        self._c_reclaimed.inc(reclaimed)
        self._h_compact.observe(dt * 1e3)
        self.obs.events.emit("compaction", live_rows=n_live,
                             reclaimed=reclaimed)
        return {"live_rows": n_live, "reclaimed": reclaimed}

    def _grow_slab(self) -> None:
        """Double every partition's slab (device realloc + host row remap).

        Only reached from ``begin_upsert`` right after a compaction, when
        live occupancy alone would overflow a slab: positions within a
        partition are preserved, so cursors (== live counts) stay valid."""
        assert int(self._cursor.max()) <= self.slab
        c, old_s = self.cfg.n_partitions, self.slab
        fills = {"members_idx": PAD_INDEX, "members_val": 0.0, "codes": 0,
                 "row_ids": ROW_PAD, "valid": False}
        new_state = []
        for st in self.state:
            st = dict(st)
            for key, fill in fills.items():
                st[key] = torch.cat([st[key], torch.full_like(st[key], fill)],
                                    dim=1)
            new_state.append(st)
        self.slab = old_s * 2
        new_id_of_row = np.full((c * self.slab,), -1, np.int64)
        new_row_of = {}
        for pid, rowvec in self.row_of.items():
            moved = tuple((r // old_s) * self.slab + (r % old_s)
                          for r in rowvec)
            new_row_of[pid] = moved
            for row in moved:
                new_id_of_row[row] = pid
        self.state = new_state
        self._shared = False
        self.row_of = new_row_of
        self.id_of_row = new_id_of_row
        self.version += 1
        self._new_steps()
        self.slab_grows += 1
        self._c_slab_grows.inc()
        self.obs.events.emit("slab_grow", slab=int(self.slab))

    def resplit(self, imbalance: float | None = None,
                by: str | None = None) -> int:
        """Skew re-split: re-hash the hottest shard's rows across the mesh.

        When per-shard skew (``max / mean``) exceeds ``imbalance`` (default
        ``maintenance.resplit`` or 2.0), the hottest shard's rows are read
        back from the slabs, the owner-hash salt is bumped, and the rows
        re-insert through the ordinary route/mutate path, spreading across
        every shard. Queries never consult the owner hash, so rows placed
        under old salts stay exactly servable. Returns the points moved.

        ``by`` picks the skew metric (default ``maintenance.
        resplit_metric``): ``"occupancy"`` watches live rows per shard;
        ``"load"`` watches queries served per shard since the last
        load-driven re-split, and a load-driven move resets the counters.
        Like ``compact()``, callers on the async write path flush it
        first (the engine does)."""
        if not self.trained:
            raise RuntimeError("build() the index before re-splitting it")
        cfg = self.cfg
        by = by if by is not None else cfg.maintenance.resplit_metric
        if by not in ("occupancy", "load"):
            raise ValueError(f"resplit by={by!r} must be 'occupancy' or "
                             "'load'")
        if self._in_maintenance:           # the re-insert upserts recurse
            return 0
        if cfg.n_shards < 2 or not self.row_of:
            return 0
        fac = imbalance if imbalance is not None \
            else (cfg.maintenance.resplit or 2.0)
        c_loc = cfg.n_partitions // cfg.n_shards
        metric = (self.query_load if by == "load"
                  else self._live_per_partition())
        shard_metric = np.asarray(metric).reshape(
            cfg.n_shards, c_loc).sum(axis=1)
        mean = float(shard_metric.mean())
        if mean <= 0 or shard_metric.max() <= fac * mean:
            return 0
        hot = int(shard_metric.argmax())
        move = [pid for pid, rowvec in self.row_of.items()
                if rowvec[0] // self.slab // c_loc == hot]
        if not move:
            return 0
        self._in_maintenance = True
        try:
            moved = self._resplit_move(move)
        finally:
            self._in_maintenance = False
        if by == "load" and moved:
            self.query_load[:] = 0
        return moved

    def _slab_rows(self, key: str, rows: np.ndarray) -> torch.Tensor:
        """Rows of one slab array at global rows (``[len(rows), K]``), on
        the index's device, in the order of ``rows``."""
        per_shard = self.cfg.n_partitions // self.cfg.n_shards * self.slab
        out = torch.empty((len(rows), self.k_dims),
                          dtype=self.state[0][key].dtype, device=self.device)
        shard = rows // per_shard
        for i, st in enumerate(self.state):
            sel = np.flatnonzero(shard == i)
            if sel.size:
                flat = st[key].reshape(-1, self.k_dims)
                local = torch.as_tensor(rows[sel] - i * per_shard,
                                        device=flat.device)
                out[torch.as_tensor(sel, device=self.device)] = \
                    flat[local].to(self.device)
        return out

    def _resplit_move(self, move: list) -> int:
        # the slabs hold the padded sparse rows: read the hot shard's
        # points back without a feature-store round trip
        rows0 = np.asarray([self.row_of[pid][0] for pid in move], np.int64)
        emb = SparseBatch(self._slab_rows("members_idx", rows0),
                          self._slab_rows("members_val", rows0))
        self.salt += 1
        self._mutate = make_mutate_step(self.mesh, self._cell(), self.salt)
        self.delete(move)
        self.upsert(np.asarray(move, np.int64), emb)
        self.resplits += 1
        self.version += 1
        self._c_resplits.inc()
        self._c_moved_points.inc(len(move))
        self.obs.events.emit("resplit", moved=len(move), salt=self.salt)
        return len(move)

    def maintenance_pressure(self, n_rows: int) -> bool:
        """True when appending ``n_rows`` more points could wrap a slab,
        i.e. a compaction / slab grow may trigger inside the next
        ``begin_upsert``. ``serve.pipeline`` closes its fuse window while
        this holds, so the pipelined schedule degenerates to the
        synchronous per-batch schedule exactly when slots may move (the
        compaction-boundary rule)."""
        if not self.trained or not self.cfg.maintenance.compact:
            return False
        return bool(int(self._cursor.max())
                    + n_rows * self.cfg.n_copies > self.slab)

    # ------------------------------------------------- versioned publishing

    def publish(self, seq: int = -1) -> IndexVersion:
        """Publish the current slabs as an immutable ``IndexVersion``.

        Shard tensors are captured by reference (the next in-place write
        copies them), the host ``id_of_row`` by copy; installing the
        version is one reference assignment. The maintenance worker
        publishes at every drain (``snapshot_swap`` events carry the
        version)."""
        self.version += 1
        self._shared = True
        self._published = IndexVersion(
            version=self.version, seq=seq, state=list(self.state or []),
            id_of_row=(self.id_of_row.copy()
                       if self.id_of_row is not None else None),
            salt=self.salt, slab=int(self.slab), points=len(self.row_of))
        return self._published

    def published(self) -> IndexVersion | None:
        """The latest published version (None before the first publish)."""
        return self._published

    # --------------------------------------------------------- persistence

    def snapshot_state(self) -> dict:
        """The host-side state the engine persists: the owner-hash salt
        (the slabs rebuild from the feature store on recovery; mixed-salt
        placements re-route identically only under the same salt)."""
        return {"salt": self.salt}

    def restore_state(self, state: dict) -> None:
        salt = state.get("salt")
        if salt is not None and salt != self.salt:
            self.salt = int(salt)
            if self.trained:
                self._mutate = make_mutate_step(self.mesh, self._cell(),
                                                self.salt)

    def occupancy(self) -> dict:
        """Slab / shard occupancy and lifecycle counters (engine stats)."""
        cfg = self.cfg
        live = self._live_per_partition()
        c_loc = cfg.n_partitions // cfg.n_shards
        shard_live = live.reshape(cfg.n_shards, c_loc).sum(axis=1)
        mean = float(shard_live.mean())
        shard_load = self.query_load.reshape(cfg.n_shards, c_loc).sum(axis=1)
        load_mean = float(shard_load.mean())
        return {
            "points": len(self.row_of),
            "live_rows": int(live.sum()),
            "slots": int(cfg.n_partitions * self.slab),
            "slab": int(self.slab),
            "cursor_max": int(self._cursor.max()),
            "partition_max": int(live.max()),
            "shard_live": shard_live.tolist(),
            "shard_imbalance": float(shard_live.max() / mean)
            if mean > 0 else 1.0,
            "shard_load": shard_load.tolist(),
            "load_imbalance": float(shard_load.max() / load_mean)
            if load_mean > 0 else 1.0,
            "soar": cfg.use_soar,
            "salt": self.salt,
            "compactions": self.compactions,
            "reclaimed_slots": self.reclaimed,
            "slab_grows": self.slab_grows,
            "resplits": self.resplits,
            "aged_out": self.aged_out,
            "version": self.version,
        }

    describe = occupancy

    # ------------------------------------------------------------- queries

    def search(self, emb: SparseBatch, k: int):
        """Top-k (ids [B,k], dists [B,k]); padding id=-1, dist=+inf."""
        if not self.trained:
            raise RuntimeError("build() the index before searching it")
        t_search = time.perf_counter()
        with self.obs.tracer.span("shard_search", batch=emb.batch, k=k):
            out = self._search(emb, k)
        self._h_search.observe((time.perf_counter() - t_search) * 1e3)
        return out

    def _search(self, emb: SparseBatch, k: int):
        cfg = self.cfg
        b = emb.batch
        cell = self._cell()
        r = min(cell.reorder or 2 * k, cell.nprobe_local * self.slab)
        k_eff = min(k, r)
        out_ids = np.full((b, k), -1, np.int64)
        out_d = np.full((b, k), np.inf, np.float32)
        sk = self._sketch(emb)
        q_idx, q_val = emb.indices.to(self.device), emb.values.to(self.device)
        step = self._query_step(k_eff)
        # query_batch queries a call: each query gathers every probed slot
        # of every shard (N = nprobe_local x slab candidates a shard)
        for lo in range(0, b, cfg.query_batch):
            hi = min(lo + cfg.query_batch, b)
            rows, dists = step(q_idx[lo:hi], q_val[lo:hi], sk[lo:hi],
                               self.state)
            rows = rows.cpu().numpy()
            dists = dists.cpu().numpy()
            hit = np.isfinite(dists)
            if hit.any():
                # per-partition read-traffic counters: every returned
                # candidate charges the partition it was served from
                # (the "load" re-split metric)
                self.query_load += np.bincount(
                    (rows[hit] // self.slab).astype(np.int64),
                    minlength=cfg.n_partitions)
            ids_c = np.where(hit, self.id_of_row[np.where(hit, rows, 0)], -1)
            out_ids[lo:hi, :k_eff] = ids_c
            out_d[lo:hi, :k_eff] = np.where(hit, dists, np.inf)
        return out_ids, out_d
