"""ANN backends behind the Dynamic GUS index protocol.

Every backend implements :class:`MutableAnnBackend` —
``build / upsert / delete / search`` over ``SparseBatch`` embeddings plus
the shared ``SnapshotStateful`` persistence pair (``core.gus.make_index``
selects one) — and :class:`StagedAnnBackend`, the three-phase mutate split
(``encode_upsert`` pure, ``begin_upsert`` host allocation + device
writes, ``finish_upsert`` the batch's barrier) that ``serve.pipeline``
double-buffers:

  brute.py     — exact full-scan index (the recall oracle);
  scann.py     — quantized ScaNN-style index (partitions + residual PQ +
                 SOAR + exact rescore);
  sharded.py   — the sharded index's query / mutate / delete / compact
                 programs, one function per shard, the collectives
                 explicit;
  sharded_index.py — ``ShardedGusIndex``: those programs behind the index
                 protocol, with the slab lifecycle (compaction, growth,
                 skew re-splits) and versioned publishing;
  partition.py — k-means partitioner + SOAR assignment;
  quantize.py  — anisotropic product-quantization codebooks;
  sparse.py    — CountSketch projection and exact sparse dots.
"""
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.ann.brute import BruteIndex
from repro_torch.ann.scann import ScannConfig, ScannIndex
from repro_torch.ann.sharded_index import ShardedConfig, ShardedGusIndex
from repro_torch.core.types import SparseBatch


@runtime_checkable
class MutableAnnBackend(Protocol):
    """The backend contract ``DynamicGUS`` programs against: bulk
    (re)load, point mutations, top-k search, and the composable
    snapshot/restore pair (``core.maintenance.SnapshotStateful``).
    Structural (``isinstance`` checks method presence only); the
    conformance tests of ``tests/test_torch_surface.py`` pin the
    behavioral contract over all three backends."""

    def build(self, ids: np.ndarray, emb: SparseBatch) -> None:
        """(Re)train routing state from scratch and load the corpus."""
        ...

    def upsert(self, ids: np.ndarray, emb: SparseBatch) -> None:
        """Insert new points / update existing ones."""
        ...

    def delete(self, ids: np.ndarray) -> int:
        """Tombstone rows; returns the number actually deleted."""
        ...

    def search(self, emb: SparseBatch, k: int):
        """Top-k by ascending distance -> (ids [B,k], dists [B,k]),
        padded with id=-1 / dist=+inf."""
        ...

    def snapshot_state(self) -> dict:
        """Minimal non-rebuildable state (routing policy), composed into
        the engine snapshot by ``DynamicGUS.snapshot_state``."""
        ...

    def restore_state(self, state: dict) -> None:
        """Install snapshot state; must run before ``build`` re-loads
        the corpus so routing decisions replay identically."""
        ...

    def __len__(self) -> int:
        ...


@runtime_checkable
class StagedAnnBackend(MutableAnnBackend, Protocol):
    """A backend whose upsert decomposes into the three-phase split the
    pipelined write path double-buffers. ``upsert`` must equal the
    composition ``finish(begin(ids, emb, encode(ids, emb)))``."""

    def encode_upsert(self, ids: np.ndarray, emb: SparseBatch):
        """Stage A, pure: routing / quantization for the batch. May
        return None when there is nothing to precompute."""
        ...

    def begin_upsert(self, ids: np.ndarray, emb: SparseBatch,
                     staged=None):
        """Stage B: host allocation + device writes; returns what
        ``finish_upsert`` waits on (the batch's CUDA event, or None)."""
        ...

    def finish_upsert(self, pending=None) -> None:
        """Barrier: wait for the batch's device writes."""
        ...
