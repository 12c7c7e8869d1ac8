"""CountSketch over the fixed-nnz padded sparse format (port of
``count_sketch`` in ``repro/ann/sparse.py``): a feature-hashing projection
into a d_proj-dim dense space, used by the partitioner and the PQ
codebooks. Exact sparse dot products live in ``kernels/sparse_dot.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.core.types import PAD_INDEX, SparseBatch


def count_sketch(sp: SparseBatch, d_proj: int, seed: int = 7) -> torch.Tensor:
    """CountSketch projection to a dense d_proj space, f32 [B, d_proj].

    The reference's scatter-add is replayed as a loop over the K columns:
    within one column every row writes one coordinate, so there are no
    colliding writes (no atomics on the card), and each coordinate sums
    its terms in column order, bitwise the reference's order.
    """
    h = hashing.uhash(seed, sp.indices) % d_proj
    s = torch.where((hashing.uhash(seed + 1, sp.indices) & 1) == 1, 1.0, -1.0)
    vals = torch.where(sp.indices == PAD_INDEX, 0.0, sp.values * s)
    out = torch.zeros((sp.batch, d_proj), dtype=torch.float32,
                      device=sp.values.device)
    rows = torch.arange(sp.batch, device=sp.values.device)
    for k in range(sp.k):
        out[rows, h[:, k]] += vals[:, k]
    return out
