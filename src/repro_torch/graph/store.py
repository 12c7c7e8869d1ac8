"""Device-resident, incrementally maintained top-k adjacency (port of
``repro/graph/store.py``).

Every live point owns a *slot*; slot ``s``'s row holds up to ``width``
(neighbor-slot, weight) entries sorted by weight descending in
``nbr_slots``/``nbr_w``, two device tensors of shape ``(capacity,
width)``. The graph is kept *exactly symmetric*: an edge (a, b, w) is in
a's row iff it is in b's row with the same weight.

  upsert  — the engine hands over each upserted point's scored
            neighborhood; the point's old edges are purged (its embedding
            changed), then the forward edges and the mirrored back-edges
            are pushed into both endpoint rows by ``_merge_rows``, a
            merge-and-retop-k on the ``topk_select`` kernel. When a full
            row evicts its weakest edge, the eviction is mirrored into the
            other endpoint so symmetry survives overflow.
  delete  — tombstone the row and purge every back-reference.

Connected components ride on top (``cc.py``): the store tracks the dirty
frontier and the labels of components that lost an edge.

Where the port differs from the reference, and why (results are the
same bit for bit):

* no padding: the reference pads row and candidate batches to powers of
  two to bound jit recompiles and drops the padded rows through
  out-of-range scatters. Torch runs eagerly and an out-of-range index is
  an error, so every batch here holds only real rows;
* ``_purge_refs`` marks the victims in a ``[capacity]`` bool and gathers
  it through ``nbr_slots`` instead of the reference's ``[capacity, width,
  victims]`` comparison (about 4 GB per call at arxiv scale);
* the adjacency is updated in place, so ``publish`` clones it: a
  ``GraphView`` never changes after it is published (the reference gets
  that for free from immutable jnp arrays);
* the lowest-index first occurrence in ``_merge_rows`` is "no equal valid
  id at a lower position", not ``argmax`` over bools.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import canonical_max_edges
from repro_torch.core.maintenance import MaintenanceConfig
from repro_torch.core.types import NeighborResult
from repro_torch.graph.cc import DEAD_LABEL, propagate_labels
from repro_torch.kernels import ops
from repro_torch.obs import stage
from repro_torch.utils import pow2_pad
from repro_torch.utils.device import resolve

# Rows per merge call and candidates per row and round (bigger groups run
# in more rounds, as in the reference: the rounds decide which evictions
# happen, so the bound is part of the result)
_MAX_ROWS = 1024
_MAX_CANDS = 64
NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    k: int = 10          # forward edges inserted per upsert (maintenance k)
    # row width (0 -> 8k): headroom for hub points whose in-degree passes k
    width: int = 0
    capacity: int = 1024  # initial slot count; the store doubles on demand
    # maintenance queries retrieve this many candidates (0 -> 2k)
    probe: int = 0
    # repair/tick and staleness knobs
    maintenance: MaintenanceConfig = MaintenanceConfig()

    def row_width(self) -> int:
        return self.width or 8 * self.k

    def probe_k(self) -> int:
        return self.probe or 2 * self.k


def _merge_rows(nbr_slots, nbr_w, rows, cand_slots, cand_w, width: int):
    """Merge-and-retop-k: push candidate edges into their target rows, in
    place. rows int64 [R] (distinct); cand_* [R, C], slot -1 / weight -inf
    padding. Returns each target's (old row, new row) slots for host-side
    eviction mirroring. Duplicate ids inside a row keep their max weight;
    selection runs on the topk_select kernel."""
    old_s, old_w = nbr_slots[rows], nbr_w[rows]
    ids = torch.cat([old_s, cand_slots], dim=1)              # [R, M]
    w = torch.cat([old_w, cand_w], dim=1)
    m = ids.shape[1]
    valid = ids >= 0
    dup = (ids[:, :, None] == ids[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]              # [R, M, M]
    w_best = torch.where(dup, w[:, None, :], NEG_INF).amax(dim=-1)
    ar = torch.arange(m, device=ids.device)
    earlier = ar[None, :, None] > ar[None, None, :]          # j < i
    first = ~(dup & earlier).any(dim=-1)
    w_final = torch.where(first & valid, w_best, NEG_INF)
    vals, idx = ops.topk_select(w_final, width)
    keep = torch.isfinite(vals)
    new_s = torch.where(keep, torch.gather(ids, 1, idx.long()), -1)
    new_w = torch.where(keep, vals, NEG_INF)
    nbr_slots[rows] = new_s
    nbr_w[rows] = new_w
    return old_s, new_s


def _purge_refs(nbr_slots, nbr_w, victims):
    """Tombstone sweep, in place: clear the victims' rows and mask every
    entry that references a victim slot. victims int64 [D]. Returns (per-row
    hit mask, directed edges removed)."""
    cap = nbr_slots.shape[0]
    is_victim = torch.zeros((cap,), dtype=torch.bool, device=nbr_slots.device)
    is_victim[victims] = True
    hit = (nbr_slots >= 0) & is_victim[nbr_slots.clamp(min=0).long()]
    row_hit = hit.any(dim=-1)
    # victims' own rows clear too; entries already masked (edges between
    # co-deleted victims) must not be counted twice
    own_extra = (nbr_slots[victims] >= 0) & ~hit[victims]
    removed = hit.sum() + own_extra.sum()
    nbr_slots.masked_fill_(hit, -1)
    nbr_w.masked_fill_(hit, NEG_INF)
    nbr_slots[victims] = -1
    nbr_w[victims] = NEG_INF
    return row_hit, removed


def _remove_in_rows(nbr_slots, nbr_w, rows, targets):
    """Directed removal, in place: in each rows[i] drop the entries equal to
    any targets[i, :] (mirrors evictions). rows int64 [R] (distinct);
    targets int32 [R, T] (-1 padding)."""
    sub_s, sub_w = nbr_slots[rows], nbr_w[rows]
    tgt = torch.where(targets >= 0, targets, -2)     # never matches -1 empties
    hit = (sub_s[:, :, None] == tgt[:, None, :]).any(dim=-1)
    nbr_slots[rows] = torch.where(hit, -1, sub_s)
    nbr_w[rows] = torch.where(hit, NEG_INF, sub_w)
    return hit.sum()


def _gather_topk(nbr_slots, nbr_w, slots, k: int):
    """Fast-path read: each requested slot's k best edges (a retop-k over
    its row: rows may hold purge holes)."""
    vals, idx = ops.topk_select(nbr_w[slots], k)
    keep = torch.isfinite(vals)
    return (torch.where(keep, torch.gather(nbr_slots[slots], 1, idx.long()),
                        -1),
            torch.where(keep, vals, NEG_INF))


def _reset_components(labels, ids_dev, alive, reset_labels):
    """Slots whose label belongs to a component that lost an edge restart
    from their own id; they form the reset part of the dirty frontier."""
    mask = torch.isin(labels, reset_labels) & alive
    return torch.where(mask, ids_dev, labels), mask


def _serve_rows(nbr_slots, nbr_w, slot_of: dict, id_of_slot: np.ndarray,
                ids: np.ndarray, k: int) -> NeighborResult:
    """Gather each requested id's k best maintained edges (shared by the
    live store and published `GraphView` versions). The graph keeps no ANN
    distances, so ``distances`` is 0 at hits and +inf at padding."""
    ids = np.asarray(ids).reshape(-1)
    slots = torch.as_tensor([slot_of[int(p)] for p in ids.tolist()],
                            dtype=torch.int64, device=nbr_slots.device)
    sl, w = _gather_topk(nbr_slots, nbr_w, slots, k)
    sl, w = sl.cpu().numpy(), w.cpu().numpy()
    hit = sl >= 0
    out_ids = np.where(hit, id_of_slot[np.where(hit, sl, 0)], -1)
    return NeighborResult(
        ids=out_ids.astype(np.int64),
        weights=np.where(hit, w, -np.inf).astype(np.float32),
        distances=np.where(hit, 0.0, np.inf).astype(np.float32))


class GraphView:
    """An immutable published version of the adjacency (the RCU read side).

    Holds its own copy of the device tensors and of the host id maps, so a
    reader holding a view keeps a self-consistent snapshot while the store
    builds the next version. ``seq`` stamps the last applied mutation
    batch the version reflects (-1 when the publisher carries none)."""

    __slots__ = ("version", "seq", "cfg", "capacity", "nbr_slots", "nbr_w",
                 "slot_of", "id_of_slot")

    def __init__(self, version: int, seq: int, cfg: GraphConfig,
                 capacity: int, nbr_slots, nbr_w, slot_of: dict,
                 id_of_slot: np.ndarray):
        self.version = version
        self.seq = seq
        self.cfg = cfg
        self.capacity = capacity
        self.nbr_slots = nbr_slots
        self.nbr_w = nbr_w
        self.slot_of = slot_of
        self.id_of_slot = id_of_slot

    def __len__(self) -> int:
        return len(self.slot_of)

    def has_ids(self, ids) -> bool:
        return all(int(p) in self.slot_of
                   for p in np.asarray(ids).reshape(-1).tolist())

    def neighbors_of_ids(self, ids: np.ndarray, k: int | None = None
                         ) -> NeighborResult:
        k = k or self.cfg.k
        return _serve_rows(self.nbr_slots, self.nbr_w, self.slot_of,
                           self.id_of_slot, ids, k)


class DynamicGraphStore:
    """Incrementally maintained symmetric top-k graph (see module doc)."""

    def __init__(self, cfg: GraphConfig = GraphConfig(), device=None):
        self.cfg = cfg
        self.device = resolve(device)
        self.width = cfg.row_width()
        if not 0 < self.cfg.k <= self.width:
            raise ValueError(f"need 0 < k <= width, got k={cfg.k} "
                             f"width={self.width}")
        self._init_arrays(max(64, pow2_pad(cfg.capacity)))
        # churn counters (directed entries)
        self.edges_added = 0
        self.edges_removed = 0
        # versioned publishing (the concurrent maintenance plane)
        self.version = 0
        self._view: GraphView | None = None

    def _full(self, shape, value, dtype) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)

    def _init_arrays(self, cap: int) -> None:
        self.capacity = cap
        self.nbr_slots = self._full((cap, self.width), -1, torch.int32)
        self.nbr_w = self._full((cap, self.width), NEG_INF, torch.float32)
        self.ids_dev = self._full((cap,), -1, torch.int32)
        self.alive = self._full((cap,), False, torch.bool)
        self.labels = self._full((cap,), int(DEAD_LABEL), torch.int32)
        self.slot_of: dict[int, int] = {}
        self.id_of_slot = np.full((cap,), -1, np.int64)
        self._free = list(range(cap - 1, -1, -1))
        self._dirty: set[int] = set()          # slots with changed edges
        self._reset_labels: set[int] = set()   # components that lost edges
        self._repair: set[int] = set()         # under-full rows to re-query
        self._cc_cache: dict | None = None
        self.cc_iters = 0                      # last propagation's rounds

    def __len__(self) -> int:
        return len(self.slot_of)

    def has_ids(self, ids) -> bool:
        return all(int(p) in self.slot_of
                   for p in np.asarray(ids).reshape(-1).tolist())

    def _slots(self, slots) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, np.int64), device=self.device)

    # ------------------------------------------------------------- plumbing

    def _grow(self) -> None:
        cap, new = self.capacity, self.capacity * 2
        self.nbr_slots = torch.cat([self.nbr_slots, self._full(
            (cap, self.width), -1, torch.int32)])
        self.nbr_w = torch.cat([self.nbr_w, self._full(
            (cap, self.width), NEG_INF, torch.float32)])
        self.ids_dev = torch.cat([self.ids_dev,
                                  self._full((cap,), -1, torch.int32)])
        self.alive = torch.cat([self.alive,
                                self._full((cap,), False, torch.bool)])
        self.labels = torch.cat([self.labels, self._full(
            (cap,), int(DEAD_LABEL), torch.int32)])
        self.id_of_slot = np.concatenate(
            [self.id_of_slot, np.full((cap,), -1, np.int64)])
        self._free.extend(range(new - 1, cap - 1, -1))
        self.capacity = new

    def _note_removed(self, slots) -> None:
        """Record that `slots` lost an incident edge: their components must
        be reset before the next CC pass. Labels are frozen between
        ``components()`` calls, so gathering them now is exact."""
        slots = [s for s in slots if s >= 0]
        if not slots:
            return
        labels = self.labels[self._slots(slots)].cpu().numpy()
        for lab in labels.tolist():
            if lab != int(DEAD_LABEL):
                self._reset_labels.add(lab)
        self._dirty.update(slots)
        self._cc_cache = None

    def _apply_purge(self, victim_slots: list) -> None:
        """Clear victims' rows and every reference to them."""
        if not victim_slots:
            return
        row_hit, removed = _purge_refs(self.nbr_slots, self.nbr_w,
                                       self._slots(victim_slots))
        touched = torch.nonzero(row_hit).reshape(-1).cpu().tolist()
        self._note_removed(list(victim_slots) + touched)
        # every row that lost an edge gets re-queried: its fresh top-k may
        # have shifted, not just shrunk (victims handle themselves)
        self._repair.update(set(touched) - set(victim_slots))
        self.edges_removed += int(removed)

    def _note_underfull(self, slots: list) -> None:
        """Rows that dropped below k live edges become repair candidates
        (the engine re-queries and merges their fresh neighborhoods)."""
        if not slots:
            return
        arr = np.asarray(slots, np.int64)
        deg = (self.nbr_slots[self._slots(arr)] >= 0).sum(dim=-1)
        self._repair.update(arr[deg.cpu().numpy() < self.cfg.k].tolist())

    # ------------------------------------------------------------ mutations

    def ensure_ids(self, ids: np.ndarray) -> None:
        """Allocate slots for ids without touching edges (bootstrap
        pre-registration, so chunked seeding can link across chunks)."""
        pids = [int(p) for p in np.asarray(ids).reshape(-1).tolist()
                if int(p) not in self.slot_of]
        if not pids:
            return
        while len(self.slot_of) + len(pids) > self.capacity:
            self._grow()
        slots = []
        for pid in pids:
            slot = self._free.pop()
            self.slot_of[pid] = slot
            self.id_of_slot[slot] = pid
            slots.append(slot)
        sl = self._slots(slots)
        pv = torch.as_tensor(pids, dtype=torch.int32, device=self.device)
        self.ids_dev[sl] = pv
        self.alive[sl] = True
        self.labels[sl] = pv
        self._dirty.update(slots)
        self._cc_cache = None

    def upsert(self, ids: np.ndarray, result: NeighborResult,
               purge: bool = True) -> None:
        """Two-sided edge update from each upserted point's scored
        neighborhood (row i of ``result`` belongs to ``ids[i]``).

        ``purge=True`` (inserts/updates) drops the point's old edges first;
        ``purge=False`` merges the fresh neighborhood into what the row
        holds (the repair path: the embedding is unchanged)."""
        ids = np.asarray(ids).reshape(-1)
        res_ids = np.asarray(result.ids)
        res_w = np.asarray(result.weights, np.float32)
        if res_ids.shape[0] != ids.size:
            raise ValueError("result rows must align to ids")
        if ids.size == 0:
            return
        if not (int(ids.min()) >= 0
                and int(ids.max()) < np.iinfo(np.int32).max):
            raise ValueError("graph ids must lie in [0, 2**31 - 1)")
        last = {int(p): i for i, p in enumerate(ids.tolist())}
        rows_sel = sorted(last.values())
        if purge:
            self._apply_purge([self.slot_of[int(ids[i])] for i in rows_sel
                               if int(ids[i]) in self.slot_of])
        self._repair.difference_update(
            self.slot_of[int(ids[i])] for i in rows_sel
            if int(ids[i]) in self.slot_of)
        self.ensure_ids(np.asarray([int(ids[i]) for i in rows_sel]))
        # directed pushes: forward (src -> nbr) and mirrored (nbr -> src)
        push_rows, push_nbrs, push_w = [], [], []
        for i in rows_sel:
            pid = int(ids[i])
            src = self.slot_of[pid]
            for nid, w in zip(res_ids[i].tolist(), res_w[i].tolist()):
                if nid < 0 or nid == pid or not np.isfinite(w):
                    continue
                dst = self.slot_of.get(int(nid))
                if dst is None or dst == src:
                    continue
                push_rows += [src, dst]
                push_nbrs += [dst, src]
                push_w += [w, w]
        with stage("graph.push_edges", rows=len(push_rows)):
            self._push_edges(np.asarray(push_rows, np.int32),
                             np.asarray(push_nbrs, np.int32),
                             np.asarray(push_w, np.float32))

    def delete(self, ids) -> int:
        """Tombstone rows and purge back-edges; slots recycle."""
        slots = []
        for pid in np.asarray(ids).reshape(-1).tolist():
            slot = self.slot_of.pop(int(pid), None)
            if slot is not None:
                slots.append(slot)
        if not slots:
            return 0
        self._apply_purge(slots)            # gathers labels before clearing
        sl = self._slots(slots)
        self.ids_dev[sl] = -1
        self.alive[sl] = False
        self.labels[sl] = int(DEAD_LABEL)
        self.id_of_slot[np.asarray(slots)] = -1
        self._free.extend(slots)
        self._dirty.difference_update(slots)
        self._repair.difference_update(slots)
        return len(slots)

    def take_repair_ids(self, limit: int | None = None) -> np.ndarray:
        """Pop up to ``limit`` under-full points for re-querying, in slot
        order (the queue is coalesced: a row touched by many purges
        appears once)."""
        limit = (limit if limit is not None
                 else self.cfg.maintenance.repair_per_tick)
        out = []
        for slot in sorted(self._repair):
            if len(out) >= limit:
                break
            self._repair.discard(slot)
            pid = int(self.id_of_slot[slot])
            if pid >= 0:                       # slot may have been recycled
                out.append(pid)
        return np.asarray(out, np.int64)

    def repair_backlog(self) -> int:
        """Rows awaiting a repair re-query (the pipeline's queue depth)."""
        return len(self._repair)

    def _push_edges(self, rows: np.ndarray, nbrs: np.ndarray,
                    ws: np.ndarray) -> None:
        """Group directed pushes by target row, merge-and-retop-k, then
        mirror any evictions so symmetry survives full rows."""
        mirror: dict[int, set] = {}
        while rows.size:
            order = np.argsort(rows, kind="stable")
            rows_s, nbrs_s, ws_s = rows[order], nbrs[order], ws[order]
            first = np.searchsorted(rows_s, rows_s, side="left")
            pos = np.arange(rows_s.size) - first
            this = pos < _MAX_CANDS                # overflow -> next round
            rows, nbrs, ws = rows_s[~this], nbrs_s[~this], ws_s[~this]
            rows_s, nbrs_s, ws_s, pos = (rows_s[this], nbrs_s[this],
                                         ws_s[this], pos[this])
            uniq = np.unique(rows_s)
            grp = np.searchsorted(uniq, rows_s)
            c = int(pos.max()) + 1
            for lo in range(0, uniq.size, _MAX_ROWS):
                sel_rows = uniq[lo:lo + _MAX_ROWS]
                in_chunk = (grp >= lo) & (grp < lo + _MAX_ROWS)
                cand_s = np.full((sel_rows.size, c), -1, np.int32)
                cand_w = np.full((sel_rows.size, c), -np.inf, np.float32)
                cand_s[grp[in_chunk] - lo, pos[in_chunk]] = nbrs_s[in_chunk]
                cand_w[grp[in_chunk] - lo, pos[in_chunk]] = ws_s[in_chunk]
                old_s, new_s = _merge_rows(
                    self.nbr_slots, self.nbr_w, self._slots(sel_rows),
                    torch.as_tensor(cand_s, device=self.device),
                    torch.as_tensor(cand_w, device=self.device), self.width)
                old_s, new_s = old_s.cpu().numpy(), new_s.cpu().numpy()
                for i, row in enumerate(sel_rows.tolist()):
                    before = set(old_s[i][old_s[i] >= 0].tolist())
                    cands = set(cand_s[i][cand_s[i] >= 0].tolist())
                    after = set(new_s[i][new_s[i] >= 0].tolist())
                    self.edges_added += len(after - before)
                    for evicted in (before | cands) - after:
                        mirror.setdefault(evicted, set()).add(row)
                self._dirty.update(sel_rows.tolist())
                self._cc_cache = None
        if mirror:
            # an eviction recorded in an early round can be undone by a later
            # round re-pushing the same edge; only mirror removals whose
            # forward side is really absent from the final adjacency
            from_rows = sorted({r for rs in mirror.values() for r in rs})
            snap = dict(zip(from_rows, self.nbr_slots[self._slots(
                from_rows)].cpu().numpy()))
            stands: dict[int, set] = {}
            for evicted, rows_of in mirror.items():
                for row in rows_of:
                    if not np.any(snap[row] == evicted):
                        stands.setdefault(evicted, set()).add(row)
            if stands:
                self._remove_mirrors(stands)

    def _remove_mirrors(self, mirror: dict) -> None:
        """Evicted edge (row, e): remove the surviving (e, row) entry."""
        all_rows = sorted(mirror)
        t = max(len(v) for v in mirror.values())
        for lo in range(0, len(all_rows), _MAX_ROWS):
            chunk = all_rows[lo:lo + _MAX_ROWS]
            targets = np.full((len(chunk), t), -1, np.int32)
            touched = set()
            for i, e in enumerate(chunk):
                tgt = sorted(mirror[e])
                targets[i, :len(tgt)] = tgt
                touched.add(e)
                touched.update(tgt)
            self._note_removed(sorted(touched))
            removed = _remove_in_rows(
                self.nbr_slots, self.nbr_w, self._slots(chunk),
                torch.as_tensor(targets, device=self.device))
            self.edges_removed += int(removed)
            self._note_underfull(chunk)

    # -------------------------------------------------------------- queries

    def neighbors_of_ids(self, ids: np.ndarray, k: int | None = None
                         ) -> NeighborResult:
        """Serve neighborhoods straight from the maintained rows: no
        re-embedding, no ANN search."""
        k = k or self.cfg.k
        if k > self.width:
            raise ValueError(f"k={k} exceeds row width {self.width}")
        return _serve_rows(self.nbr_slots, self.nbr_w, self.slot_of,
                           self.id_of_slot, ids, k)

    # ------------------------------------------------- versioned publishing

    def publish(self, seq: int = -1) -> GraphView:
        """Publish the current adjacency as an immutable `GraphView`: a
        device copy of the adjacency (the store updates it in place) and
        host copies of the id maps. Installing the view is one reference
        assignment, so a publish is never observed half-built. ``seq``
        stamps the last applied mutation batch this version reflects."""
        self.version += 1
        self._view = GraphView(
            version=self.version, seq=seq, cfg=self.cfg,
            capacity=self.capacity, nbr_slots=self.nbr_slots.clone(),
            nbr_w=self.nbr_w.clone(), slot_of=dict(self.slot_of),
            id_of_slot=self.id_of_slot.copy())
        return self._view

    def view(self) -> GraphView:
        """The latest published version (publishing one if none exists)."""
        if self._view is None:
            self.publish()
        return self._view

    def edges(self) -> tuple:
        """Canonical undirected edge list (pairs int64 [E, 2] with
        id_a < id_b, weights f32 [E]), deduped at max weight."""
        s = self.nbr_slots.cpu().numpy()
        w = self.nbr_w.cpu().numpy()
        rows = np.broadcast_to(np.arange(self.capacity)[:, None], s.shape)
        valid = (s >= 0) & np.isfinite(w)
        pairs, best = canonical_max_edges(
            self.id_of_slot[rows[valid]], self.id_of_slot[s[valid]],
            w[valid])
        return pairs, best.astype(np.float32)

    # ------------------------------------------------- connected components

    def components(self) -> dict:
        """{point id -> component label (min id in component)}. Converges
        only over the dirty frontier; exact after arbitrary interleavings
        (components that lost an edge are reset, then relabelled)."""
        if self._cc_cache is not None:
            return self._cc_cache
        labels = self.labels
        active = torch.zeros((self.capacity,), dtype=torch.bool,
                             device=self.device)
        if self._reset_labels:
            rl = torch.as_tensor(sorted(self._reset_labels),
                                 dtype=torch.int32, device=self.device)
            labels, mask = _reset_components(labels, self.ids_dev,
                                             self.alive, rl)
            active |= mask
        if self._dirty:
            active[self._slots(sorted(self._dirty))] = True
        labels, iters = propagate_labels(labels, self.nbr_slots, self.alive,
                                         active)
        self.labels = labels
        self.cc_iters = int(iters)
        self._dirty.clear()
        self._reset_labels.clear()
        labels_np = labels.cpu().numpy()
        self._cc_cache = {pid: int(labels_np[slot])
                          for pid, slot in self.slot_of.items()}
        return self._cc_cache

    # --------------------------------------------------------- persistence

    def snapshot_state(self) -> dict:
        """Full graph state as host arrays, in the reference's format (CC
        state rides along so a recovered engine resumes converged)."""
        self.components()                       # fold pending churn in
        return {
            "cfg": self.cfg,
            "nbr_slots": self.nbr_slots.cpu().numpy(),
            "nbr_w": self.nbr_w.cpu().numpy(),
            "ids_dev": self.ids_dev.cpu().numpy(),
            "alive": self.alive.cpu().numpy(),
            "labels": self.labels.cpu().numpy(),
            "id_of_slot": self.id_of_slot.copy(),
            "slot_of": dict(self.slot_of),
            "free": list(self._free),
            # under-full rows still awaiting re-query must survive recovery
            "repair": sorted(self._repair),
        }

    def restore_state(self, state: dict) -> None:
        def dev(a, dtype):                      # a private, writable copy
            return torch.as_tensor(np.array(a), dtype=dtype,
                                   device=self.device)

        self.cfg = state["cfg"]
        self.width = self.cfg.row_width()
        self.capacity = state["nbr_slots"].shape[0]
        self.nbr_slots = dev(state["nbr_slots"], torch.int32)
        self.nbr_w = dev(state["nbr_w"], torch.float32)
        self.ids_dev = dev(state["ids_dev"], torch.int32)
        self.alive = dev(state["alive"], torch.bool)
        self.labels = dev(state["labels"], torch.int32)
        self.id_of_slot = np.asarray(state["id_of_slot"]).copy()
        self.slot_of = dict(state["slot_of"])
        self._free = list(state["free"])
        self._dirty = set()
        self._reset_labels = set()
        self._repair = set(state.get("repair", ()))
        self._cc_cache = None
        self._view = None

    def restore(self, state: dict) -> None:
        """Alias of ``restore_state`` (the ``SnapshotStateful`` spelling)."""
        self.restore_state(state)

    # --------------------------------------------------------------- stats

    def describe(self) -> dict:
        """Structured summary of the maintained graph."""
        n_entries = int((self.nbr_slots >= 0).sum())
        return {
            "nodes": len(self.slot_of),
            "edges": n_entries // 2,
            "capacity": self.capacity,
            "width": self.width,
            "edges_added": self.edges_added,
            "edges_removed": self.edges_removed,
            "repair_backlog": len(self._repair),
            "cc_iters": self.cc_iters,
            "cc_components": (len(set(self._cc_cache.values()))
                              if self._cc_cache is not None else None),
            "version": self.version,
        }
