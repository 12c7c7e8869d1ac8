"""Exact dynamic index over sparse embeddings (port of
``repro/ann/brute.py``).

The correctness oracle for the quantized index (the recall check of
``chip_smoke.py``) and the exact backend of ``DynamicGUS``. A search is
two kernels, as the reference's ``sparse_dot`` -> mask -> ``lax.top_k``:
the shared-db ``sparse_dot`` with the tombstones masked to -inf in the
same launch, then ``topk_select`` in ``lax.top_k``'s order. Layout:
power-of-two capacity device slabs plus a host id->slot map; inserts
scatter rows into free slots, deletes tombstone the validity mask.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import PAD_INDEX, SparseBatch
from repro_torch.kernels import ops
from repro_torch.kernels.topk_select import chunk_plan, topk_select
from repro_torch.utils.device import resolve


class BruteIndex:
    """Exact ANN index: negative-dot-product distance over SparseBatch rows."""

    def __init__(self, k_dims: int, capacity: int = 1024, device=None):
        self.k_dims = k_dims
        self.device = resolve(device)
        self.capacity = max(64, int(2 ** np.ceil(np.log2(capacity))))
        self._alloc(self.capacity)
        self.slot_of: dict[int, int] = {}
        self.free: list[int] = list(range(self.capacity - 1, -1, -1))

    def _alloc(self, cap: int) -> None:
        dev = self.device
        self.db_idx = torch.full((cap, self.k_dims), PAD_INDEX,
                                 dtype=torch.int64, device=dev)
        self.db_val = torch.zeros((cap, self.k_dims), dtype=torch.float32,
                                  device=dev)
        self.valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
        self.ids = np.full((cap,), -1, np.int64)

    def __len__(self) -> int:
        return len(self.slot_of)

    def _grow(self, need: int) -> None:
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        pad = new_cap - self.capacity
        dev = self.device
        self.db_idx = torch.cat([self.db_idx, torch.full(
            (pad, self.k_dims), PAD_INDEX, dtype=torch.int64, device=dev)])
        self.db_val = torch.cat([self.db_val, torch.zeros(
            (pad, self.k_dims), dtype=torch.float32, device=dev)])
        self.valid = torch.cat([self.valid, torch.zeros(
            (pad,), dtype=torch.bool, device=dev)])
        self.ids = np.concatenate([self.ids, np.full((pad,), -1, np.int64)])
        # prepend so grown (higher) slots are popped last: the slot layout
        # depends only on the op sequence, as in the reference
        self.free[:0] = range(new_cap - 1, self.capacity - 1, -1)
        self.capacity = new_cap

    # ------------------------------------------------------------ mutations

    def build(self, ids: np.ndarray, emb: SparseBatch) -> None:
        """(Re)load from scratch; exact search has nothing to train."""
        self._alloc(self.capacity)
        self.slot_of.clear()
        self.free = list(range(self.capacity - 1, -1, -1))
        self.upsert(ids, emb)

    def upsert(self, ids: np.ndarray, emb: SparseBatch) -> None:
        """Insert new points / update existing ones (paper §3.3.1)."""
        self.finish_upsert(
            self.begin_upsert(ids, emb, self.encode_upsert(ids, emb)))

    def encode_upsert(self, ids: np.ndarray, emb: SparseBatch):
        """Stage A: nothing to route or quantize for exact search."""
        return None

    def begin_upsert(self, ids: np.ndarray, emb: SparseBatch, staged=None):
        ids = np.asarray(ids)
        need = len(self.slot_of) + len(ids)
        if need > self.capacity:
            self._grow(need)
        slots = np.empty((len(ids),), np.int64)
        for i, pid in enumerate(ids.tolist()):
            slot = self.slot_of.get(pid)
            if slot is None:
                slot = self.free.pop()
                self.slot_of[pid] = slot
                self.ids[slot] = pid
            slots[i] = slot
        sl = torch.as_tensor(slots, device=self.device)
        self.db_idx[sl] = emb.indices
        self.db_val[sl] = emb.values
        self.valid[sl] = True
        return None

    def finish_upsert(self, pending=None) -> None:
        """Barrier: wait for the device writes."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def delete(self, ids) -> int:
        """Tombstone rows (paper §3.3.2). Returns #actually deleted."""
        slots = []
        for pid in np.asarray(ids).tolist():
            slot = self.slot_of.pop(pid, None)
            if slot is not None:
                slots.append(slot)
                self.ids[slot] = -1
                self.free.append(slot)
        if not slots:
            return 0
        self.valid[torch.as_tensor(slots, device=self.device)] = False
        return len(slots)

    # -------------------------------------------------------------- queries

    def search(self, emb: SparseBatch, k: int):
        """Top-k by ascending distance. Returns (ids [B,k], dists [B,k]);
        missing neighbors padded with id=-1, dist=+inf. On the card a k
        the split top-k does not take raises ``ValueError``
        (``topk_select.chunk_plan``: k <= 4,096 once the capacity passes
        8,192)."""
        k_eff = min(k, self.capacity)
        if self.device.type == "cuda":
            chunk_plan(self.capacity, k_eff)       # raises, naming the limit
        scores = ops.sparse_dot(emb.indices, emb.values, self.db_idx,
                                self.db_val, valid=self.valid)
        top, slots = topk_select(scores, k_eff, signed_zeros=True)
        scores, slots = top.cpu().numpy(), slots.cpu().numpy()
        ids = np.where(np.isfinite(scores), self.ids[slots], -1)
        dists = np.where(np.isfinite(scores), -scores, np.inf)
        if k > k_eff:
            pad = ((0, 0), (0, k - k_eff))
            ids = np.pad(ids, pad, constant_values=-1)
            dists = np.pad(dists, pad, constant_values=np.inf)
        return ids, dists.astype(np.float32)

    def search_threshold(self, emb: SparseBatch, tau: float = 0.0):
        """All points with Dist < tau (Lemma 4.1 retrieval mode). Returns
        a list (one per query row) of (ids, dists) numpy arrays."""
        scores = ops.sparse_dot(emb.indices, emb.values, self.db_idx,
                                self.db_val, valid=self.valid).cpu().numpy()
        out = []
        for row in scores:
            hit = ((-row) < tau) & (self.ids != -1)
            out.append((self.ids[hit].copy(), (-row[hit]).astype(np.float32)))
        return out
