"""Dynamic ScaNN-style index: partitions + residual PQ + SOAR + exact
rescore (port of ``repro/ann/scann.py``).

  sparse embedding --CountSketch--> sketch
      --centroid matmul--> top-``nprobe`` partitions
      --fused PQ shortlist kernel over partition slabs--> ``reorder`` cands
      --exact sparse rescore + top-k kernel--> final top-k.

Storage discipline, as in the reference: one global slab row per point
(the padded sparse row, by slot); per-(partition, position) PQ codes
for the primary and the SOAR secondary copy; device arrays that grow by
power-of-two doubling; host-side id -> (slot, (p1,pos1), (p2,pos2)) maps
and per-partition free lists, so the slot and slab layout depend only on
the operation sequence.

Every ``lax.top_k`` of the reference is a stable descending sort here
(``kernels.ref.topk_ref``) or a kernel's selection (``topk_select``, the
rescore's): ties go to the lowest index, as they do there. The
reference's ``use_kernels`` switch has no counterpart: the device decides
(kernels on the card, their plain versions on the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.ann import partition as part_mod
from repro_torch.ann import quantize as pq
from repro_torch.ann.sparse import count_sketch
from repro_torch.core.types import PAD_INDEX, SparseBatch
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_ref
from repro_torch.utils.device import record_writes, resolve


# queries per _query_step call (see ScannIndex.search)
SEARCH_CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class ScannConfig:
    d_proj: int = 64            # CountSketch dimension
    n_partitions: int = 64
    pq_subspaces: int = 8       # M (one byte/code each)
    pq_centers: int = 256
    nprobe: int = 8             # partitions searched per query
    reorder: int = 128          # shortlist size for exact rescoring
    eta: float = 4.0            # anisotropic weight (1.0 = plain L2)
    soar_lambda: float = 1.0    # SOAR orthogonality weight (<0 disables SOAR)
    kmeans_iters: int = 12
    pq_iters: int = 8
    fused: bool = True          # one fused shortlist kernel (False: composed)
    pq_int8: bool = False       # quantized int8 LUT scoring in the shortlist
    seed: int = 13

    @property
    def use_soar(self) -> bool:
        return self.soar_lambda >= 0


def _query_step(q_idx, q_val, q_sketch, centroids, books, members,
                codes_list, valid_list, sp_idx, sp_val, *, nprobe: int,
                reorder: int, k: int, fused: bool = True,
                pq_int8: bool = False):
    """Batched query: returns (slots [B,k], dists [B,k]); empty = -1/+inf.

    ``fused`` takes the shortlist (PQ LUT scores, SOAR dedup, top-r) in one
    kernel; ``fused=False`` composes the same stages from the pq-score
    kernel, the top-k selection and the dedup mask, bitwise the same by
    the fused shortlist's contract. ``pq_int8`` scores the shortlist from
    a symmetric int8 table.

    SOAR dedup happens at the shortlist cut: both copies of a point carry
    the same slot number, so the lower-ranked copy becomes -inf and the
    exact rescore sees each slot once.
    """
    b = q_idx.shape[0]
    s = members.shape[1]
    m = books.shape[0]

    # 1) partition selection (dot scores)
    pscores = part_mod.partition_scores(q_sketch, centroids)        # [B, C]
    top_ps, top_parts = topk_ref(pscores, nprobe)                  # [B, np]

    # 2+3) PQ LUT scoring over the probed slabs, SOAR dedup, shortlist
    lut = pq.query_lut(q_sketch, books)                             # [B, M, C]
    flat_slots = members[top_parts].reshape(b, -1)                  # [B, N]
    flat_codes = codes_list[top_parts].reshape(b, -1, m)            # [B, N, M]
    flat_valid = valid_list[top_parts].reshape(b, -1) & (flat_slots >= 0)
    bias = top_ps.repeat_interleave(s, dim=-1)                      # + q . c_p
    r = min(reorder, flat_slots.shape[-1])
    if fused:
        short_scores, short_pos = ops.pq_score_dedup_topk(
            lut, flat_codes, flat_slots, r, valid=flat_valid, bias=bias,
            quantized=pq_int8)
    else:
        approx = ops.pq_scores(lut, flat_codes, quantized=pq_int8)
        approx = torch.where(flat_valid, approx + bias, float("-inf"))
        short_scores, short_pos = ops.topk_select(approx, r)
        short_scores = ops.dedup_mask(short_scores, short_pos, flat_slots,
                                      flat_valid)
    # 4) exact sparse-space rescore of the shortlist (-inf entries, invalid
    # or a duplicate SOAR copy, drop out) and the final top-k, one kernel
    return ops.sparse_rescore_topk(q_idx, q_val, flat_slots, short_pos,
                                   short_scores, sp_idx, sp_val, k)


class ScannIndex:
    """Dynamic quantized index over sparse embeddings."""

    # updates re-route free-list slots, so fusing them into a window
    # changes slab layout (and PQ-tie ordering at the shortlist cut);
    # serve.pipeline closes the fuse window before updates of live ids
    FUSED_UPDATES_EXACT = False

    def __init__(self, k_dims: int, cfg: ScannConfig, device=None):
        self.k_dims = k_dims
        self.cfg = cfg
        self.device = resolve(device)
        self.capacity = 0
        self.slot_of: dict[int, tuple] = {}  # id -> (slot, (p,pos), (p,pos)|None)
        self.free_slots: list[int] = []
        self.part_free: list[list[int]] = []
        self.centroids = None
        self.books = None
        self.trained = False

    def __len__(self) -> int:
        return len(self.slot_of)

    # ------------------------------------------------------------- storage

    def _alloc(self, capacity: int, slab: int) -> None:
        cfg = self.cfg
        c = cfg.n_partitions
        dev = self.device
        self.capacity = capacity
        self.slab = slab
        self.sp_idx = torch.full((capacity, self.k_dims), PAD_INDEX,
                                 dtype=torch.int64, device=dev)
        self.sp_val = torch.zeros((capacity, self.k_dims), dtype=torch.float32,
                                  device=dev)
        self.members = torch.full((c, slab), -1, dtype=torch.int32, device=dev)
        self.codes_list = torch.zeros((c, slab, cfg.pq_subspaces),
                                      dtype=torch.uint8, device=dev)
        self.valid_list = torch.zeros((c, slab), dtype=torch.bool, device=dev)
        self.ids = np.full((capacity,), -1, np.int64)
        self.free_slots = list(range(capacity - 1, -1, -1))
        self.part_free = [list(range(slab - 1, -1, -1)) for _ in range(c)]

    def _grow_slots(self, need: int) -> None:
        new_cap = max(self.capacity, 64)
        while new_cap < need:
            new_cap *= 2
        pad = new_cap - self.capacity
        if pad == 0:
            return
        dev = self.device
        self.sp_idx = torch.cat([self.sp_idx, torch.full(
            (pad, self.k_dims), PAD_INDEX, dtype=torch.int64, device=dev)])
        self.sp_val = torch.cat([self.sp_val, torch.zeros(
            (pad, self.k_dims), dtype=torch.float32, device=dev)])
        self.ids = np.concatenate([self.ids, np.full((pad,), -1, np.int64)])
        self.free_slots = list(range(new_cap - 1, self.capacity - 1, -1)) \
            + self.free_slots
        self.capacity = new_cap

    def _grow_slab(self) -> None:
        old = self.slab
        self.slab = old * 2
        c = self.cfg.n_partitions
        dev = self.device
        self.members = torch.cat([self.members, torch.full(
            (c, old), -1, dtype=torch.int32, device=dev)], dim=1)
        self.codes_list = torch.cat([self.codes_list, torch.zeros(
            (c, old, self.cfg.pq_subspaces), dtype=torch.uint8, device=dev)],
            dim=1)
        self.valid_list = torch.cat([self.valid_list, torch.zeros(
            (c, old), dtype=torch.bool, device=dev)], dim=1)
        for fl in self.part_free:
            fl[:0] = range(self.slab - 1, old - 1, -1)

    # ------------------------------------------------------------ training

    def build(self, ids: np.ndarray, emb: SparseBatch) -> None:
        """Offline build (paper §4.3): train partitions + codebooks, load.
        Idempotent: previously loaded state is discarded."""
        cfg = self.cfg
        self.slot_of.clear()
        n = emb.batch
        sk = count_sketch(emb, cfg.d_proj, cfg.seed)
        self.centroids = part_mod.kmeans(
            sk, cfg.n_partitions, cfg.kmeans_iters, cfg.eta, cfg.seed)
        p1, _ = part_mod.assign_partitions(sk, self.centroids, cfg.eta,
                                           max(cfg.soar_lambda, 0.0))
        self.books = pq.train_codebooks(
            sk - self.centroids[p1], cfg.pq_subspaces, cfg.pq_centers,
            cfg.pq_iters, cfg.eta, cfg.seed)
        self.trained = True
        per_copy = 2 if cfg.use_soar else 1
        slab = 64
        while slab * cfg.n_partitions < per_copy * n * 2:
            slab *= 2
        self._alloc(max(64, int(2 ** np.ceil(np.log2(max(n, 1) * 2)))), slab)
        self.upsert(ids, emb)

    @classmethod
    def from_trained(cls, k_dims: int, cfg: ScannConfig, centroids, books,
                     capacity: int = 1024, slab: int = 64,
                     device=None) -> "ScannIndex":
        """An EMPTY dynamic index from offline-trained structures (paper
        §4.3): every point then arrives through the mutation path."""
        idx = cls(k_dims, cfg, device)
        idx.centroids = torch.as_tensor(centroids, dtype=torch.float32,
                                        device=idx.device)
        idx.books = torch.as_tensor(books, dtype=torch.float32,
                                    device=idx.device)
        idx.trained = True
        cap = max(64, int(2 ** np.ceil(np.log2(max(capacity, 1)))))
        s = max(64, int(2 ** np.ceil(np.log2(max(slab, 1)))))
        idx._alloc(cap, s)
        return idx

    def rebuild(self) -> None:
        """Periodic retrain + compaction on the live points (paper §4.3):
        their rows in ``slot_of``'s insertion order, gathered on the
        index's device, then ``build`` from scratch. The old slabs are
        dropped before ``build`` allocates the new ones, so the peak holds
        one layout and the live rows, not two layouts."""
        if not self.slot_of:
            return
        pids = np.fromiter(self.slot_of, np.int64, len(self.slot_of))
        slots = torch.as_tensor([rec[0] for rec in self.slot_of.values()],
                                dtype=torch.int64, device=self.device)
        emb = SparseBatch(self.sp_idx[slots], self.sp_val[slots])
        self.slot_of.clear()
        self.sp_idx = self.sp_val = None
        self.members = self.codes_list = self.valid_list = None
        self.build(pids, emb)

    # ----------------------------------------------------------- mutations

    def upsert(self, ids: np.ndarray, emb: SparseBatch) -> None:
        self.finish_upsert(
            self.begin_upsert(ids, emb, self.encode_upsert(ids, emb)))

    def encode_upsert(self, ids: np.ndarray, emb: SparseBatch) -> dict:
        """Stage A: sketch, partition routing, residual PQ codes (pure)."""
        if not self.trained:
            raise RuntimeError("build() the index before mutating it")
        cfg = self.cfg
        sk = count_sketch(emb, cfg.d_proj, cfg.seed)
        p1, p2 = part_mod.assign_partitions(sk, self.centroids, cfg.eta,
                                            max(cfg.soar_lambda, 0.0))
        codes1 = pq.encode(sk - self.centroids[p1], self.books)
        codes2 = pq.encode(sk - self.centroids[p2], self.books)
        return {"p1": p1, "p2": p2, "codes1": codes1, "codes2": codes2}

    def begin_upsert(self, ids: np.ndarray, emb: SparseBatch,
                     staged: dict | None = None):
        """Stage B: slot allocation on the host + batched device writes."""
        if not self.trained:
            raise RuntimeError("build() the index before mutating it")
        cfg = self.cfg
        ids = np.asarray(ids)
        if staged is None:
            staged = self.encode_upsert(ids, emb)
        self.delete([pid for pid in ids.tolist() if pid in self.slot_of])
        n = len(ids)
        if len(self.slot_of) + n > self.capacity:
            self._grow_slots(len(self.slot_of) + n)

        p1_np = staged["p1"].cpu().numpy()
        p2_np = staged["p2"].cpu().numpy()

        slots = np.empty((n,), np.int64)
        rows, cols, aslots, which, src = [], [], [], [], []
        for i, pid in enumerate(ids.tolist()):
            slot = self.free_slots.pop()
            slots[i] = slot
            self.ids[slot] = pid
            copies = [(int(p1_np[i]), 0)]
            if cfg.use_soar:
                copies.append((int(p2_np[i]), 1))
            recs = []
            for p, w in copies:
                if not self.part_free[p]:
                    self._grow_slab()
                pos = self.part_free[p].pop()
                rows.append(p)
                cols.append(pos)
                aslots.append(slot)
                which.append(w)
                src.append(i)
                recs.append((p, pos))
            self.slot_of[pid] = (int(slot),) + tuple(recs)

        dev = self.device
        sl = torch.as_tensor(slots, device=dev)
        self.sp_idx[sl] = emb.indices
        self.sp_val[sl] = emb.values
        rows_t = torch.as_tensor(rows, dtype=torch.int64, device=dev)
        cols_t = torch.as_tensor(cols, dtype=torch.int64, device=dev)
        src_t = torch.as_tensor(src, dtype=torch.int64, device=dev)
        first = torch.as_tensor(which, device=dev)[:, None] == 0
        codes_all = torch.where(first, staged["codes1"][src_t],
                                staged["codes2"][src_t])
        self.members[rows_t, cols_t] = torch.as_tensor(
            aslots, dtype=torch.int32, device=dev)
        self.codes_list[rows_t, cols_t] = codes_all
        self.valid_list[rows_t, cols_t] = True
        return record_writes(dev)

    def finish_upsert(self, pending=None) -> None:
        """Barrier: wait for this batch's device writes, the event
        ``begin_upsert`` recorded after them (the acknowledgement of a
        mutation RPC means they are done)."""
        if pending is not None:
            pending.synchronize()

    def delete(self, ids) -> int:
        rows, cols = [], []
        n_del = 0
        for pid in list(ids):
            rec = self.slot_of.pop(int(pid), None)
            if rec is None:
                continue
            n_del += 1
            slot = rec[0]
            self.ids[slot] = -1
            self.free_slots.append(slot)
            for p, pos in rec[1:]:
                rows.append(p)
                cols.append(pos)
                self.part_free[p].append(pos)
        if rows:
            dev = self.device
            self.valid_list[torch.as_tensor(rows, device=dev),
                            torch.as_tensor(cols, device=dev)] = False
        return n_del

    # --------------------------------------------------------- persistence

    def snapshot_state(self) -> dict:
        """Nothing beyond the corpus: partitions and codebooks retrain from
        the feature store on recovery with no routing state to carry."""
        return {}

    def restore_state(self, state: dict) -> None:
        pass

    # ------------------------------------------------------------- queries

    def search(self, emb: SparseBatch, k: int):
        """Top-k (ids [B,k], dists [B,k]); padding id=-1, dist=+inf.

        Batches above ``SEARCH_CHUNK`` queries run in chunks of that many:
        each query gathers nprobe x slab candidates (about 0.6 MB at the
        arxiv-scale layout), so a graph repair flush of tens of thousands
        of ids would otherwise need tens of GB. Rows are independent."""
        cfg = self.cfg
        sk = count_sketch(emb, cfg.d_proj, cfg.seed)
        parts = []
        for lo in range(0, max(emb.batch, 1), SEARCH_CHUNK):
            hi = lo + SEARCH_CHUNK
            parts.append(_query_step(
                emb.indices[lo:hi], emb.values[lo:hi], sk[lo:hi],
                self.centroids, self.books, self.members, self.codes_list,
                self.valid_list, self.sp_idx, self.sp_val,
                nprobe=min(cfg.nprobe, cfg.n_partitions),
                reorder=cfg.reorder, k=min(k, cfg.reorder), fused=cfg.fused,
                pq_int8=cfg.pq_int8))
        slots = torch.cat([p[0] for p in parts]).cpu().numpy()
        dists = torch.cat([p[1] for p in parts]).cpu().numpy()
        ids = np.where(slots >= 0, self.ids[np.maximum(slots, 0)], -1)
        if k > ids.shape[1]:
            pad = ((0, 0), (0, k - ids.shape[1]))
            ids = np.pad(ids, pad, constant_values=-1)
            dists = np.pad(dists, pad, constant_values=np.inf)
        return ids, dists.astype(np.float32)

    def search_threshold(self, emb: SparseBatch, tau: float = 0.0):
        """All shortlisted points with Dist < tau, per query row in the
        search's order: approximate, bounded by ``reorder`` (the exact form
        is ``BruteIndex.search_threshold``). Returns a list of (ids, dists)
        numpy arrays."""
        ids, dists = self.search(emb, self.cfg.reorder)
        out = []
        for row_ids, row_d in zip(ids, dists):
            hit = (row_d < tau) & (row_ids >= 0)
            out.append((row_ids[hit], row_d[hit]))
        return out
