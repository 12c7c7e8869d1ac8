"""Ops over the fixed-nnz padded sparse format (port of
``repro/ann/sparse.py``):

* the exact sparse dots: ``sparse_dot_pair`` (two rows, plain torch),
  ``sparse_dot_one_many`` and ``sparse_dot_many_many`` (through the
  shared-db ``sparse_dot`` kernel on the card, its plain version on the
  CPU);
* ``count_sketch`` — the feature-hashing projection into a d_proj-dim
  dense space, used by the partitioner and the PQ codebooks (through the
  ``count_sketch`` kernel on the card, its plain version on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PAD_INDEX, SparseBatch
from repro_torch.kernels import ops, sketch


def sparse_dot_pair(qi, qv, di, dv) -> torch.Tensor:
    """Dot of two padded sparse rows: sum over matching indices."""
    eq = (qi[:, None] == di[None, :]) & (qi[:, None] != PAD_INDEX)
    return torch.where(eq, qv[:, None] * dv[None, :], 0.0).sum()


def sparse_dot_one_many(qi, qv, db_idx, db_val) -> torch.Tensor:
    """One query row vs a database block.

    qi,qv: [Kq]; db_idx,db_val: [N, Kd] -> scores f32 [N]."""
    return ops.sparse_dot(qi[None], qv[None], db_idx, db_val)[0]


def sparse_dot_many_many(q: SparseBatch, db: SparseBatch) -> torch.Tensor:
    """All-pairs scores f32 [Bq, N]: one launch of the shared-db kernel."""
    return ops.sparse_dot(q.indices, q.values, db.indices, db.values)


def count_sketch(sp: SparseBatch, d_proj: int, seed: int = 7) -> torch.Tensor:
    """CountSketch projection to a dense d_proj space, f32 [B, d_proj].

    Each coordinate sums its terms in column order, bitwise the
    reference's scatter-add: one launch of the ``count_sketch`` kernel on
    the card, its plain column loop on the CPU (``kernels/sketch.py``).
    """
    return sketch.count_sketch(sp.indices, sp.values, d_proj, seed)
