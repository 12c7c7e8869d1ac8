"""Partitioning layer of the ScaNN-style index: k-means + SOAR spilling
(port of ``repro/ann/partition.py``).

Assignment uses the anisotropic (score-aware) cost of Guo et al. 2020,

    cost(x, c) = ||x - c||^2 + (eta - 1) * ((x - c) . x_hat)^2,

and SOAR (Sun et al. 2024) adds a secondary partition whose residual is
as orthogonal as possible to the primary one:

    soar_cost(x, c_j) = ||r_j||^2 + lam * ((r_j . r1_hat))^2.

The k-means init draws from a ``torch.Generator`` seeded with ``seed``, so
its centroids differ from the reference's; they are judged by recall.

Every [N, C] cost is built and reduced to its argmin a block of rows at a
time (``_blocked_argmin``), at most ``COST_BLOCK_BYTES`` of float32 cost a
block: at ogbn-products' bootstrap (1,469,417 rows x 9,566 partitions) one
whole matrix is 52 GiB. A cost that fits is built whole, as one block.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# float32 bytes of the cost block whose argmin is taken before the next
COST_BLOCK_BYTES = 1 << 30


def _blocked_argmin(n: int, width: int,
                    block_argmin: Callable[[slice], torch.Tensor]
                    ) -> torch.Tensor:
    """``block_argmin(rows)``, an [n, width] float32 cost over the slice
    ``rows`` of the n rows reduced to its argmin, over row blocks of at
    most ``COST_BLOCK_BYTES`` (at least one row), concatenated; one call
    on all n rows when the cost fits."""
    step = max(1, COST_BLOCK_BYTES // (4 * width))
    if step >= n:
        return block_argmin(slice(0, n))
    return torch.cat([block_argmin(slice(lo, min(lo + step, n)))
                      for lo in range(0, n, step)])


def _pairwise_sq_dist(x, c):
    # [N, C] squared distances via the expanded form
    return ((x * x).sum(-1)[:, None] - 2.0 * x @ c.T
            + (c * c).sum(-1)[None, :])


def anisotropic_cost(x, c, eta: float):
    """[N, C] score-aware assignment cost."""
    d2 = _pairwise_sq_dist(x, c)
    if eta == 1.0:
        return d2
    xn = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-9)
    # ((x - c) . x_hat) = ||x|| - c . x_hat
    par = torch.linalg.norm(x, dim=-1)[:, None] - xn @ c.T
    return d2 + (eta - 1.0) * par * par


def segment_sum(x: torch.Tensor, assign: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` summed per id in ``assign`` (``lengths`` = its
    bincount): [len(lengths), *x.shape[1:]]. Each sum adds its rows in
    index order (a stable sort by id, then a segmented sum), so on the
    card the bits repeat from run to run, where ``index_add_``'s float
    atomics add in the order they land; on the CPU it equals
    ``index_add_`` bit for bit."""
    order = torch.argsort(assign, stable=True)
    return torch.segment_reduce(x[order], "sum", lengths=lengths, axis=0)


def _nearest(x, centroids, eta: float):
    """Each row's partition of least anisotropic cost [N]."""
    return _blocked_argmin(
        x.shape[0], centroids.shape[0],
        lambda rows: anisotropic_cost(x[rows], centroids, eta).argmin(-1))


def _lloyd_step(x, centroids, eta: float):
    assign = _nearest(x, centroids, eta)
    counts = torch.bincount(assign, minlength=centroids.shape[0])
    sums = segment_sum(x, assign, counts)
    counts = counts[:, None]
    new_c = torch.where(counts > 0, sums / counts.clamp(min=1).to(x.dtype),
                        centroids)
    return new_c, assign


def sample_rows(n: int, count: int, seed: int, device) -> torch.Tensor:
    """``count`` row indices of ``n``, distinct when ``n >= count``."""
    gen = torch.Generator().manual_seed(seed)
    if n >= count:
        idx = torch.randperm(n, generator=gen)[:count]
    else:
        idx = torch.randint(n, (count,), generator=gen)
    return idx.to(device)


def kmeans(x: torch.Tensor, n_clusters: int, iters: int = 20,
           eta: float = 1.0, seed: int = 0) -> torch.Tensor:
    """K-means in sketch space. Returns centroids f32 [n_clusters, d]."""
    centroids = x[sample_rows(x.shape[0], n_clusters, seed, x.device)]
    for _ in range(iters):
        centroids, _ = _lloyd_step(x, centroids, eta)
    return centroids


def soar_cost(x, centroids, d2, p1, soar_lambda: float):
    """SOAR secondary-assignment cost given the primary ``p1``: residual
    norm plus the weighted component parallel to the primary residual.
    ``d2`` is the caller's [N, C] base cost."""
    r1 = x - centroids[p1]                                     # primary residual
    r1n = r1 / (torch.linalg.norm(r1, dim=-1, keepdim=True) + 1e-9)
    par = (x * r1n).sum(-1)[:, None] - r1n @ centroids.T      # (x - c_j) . r1_hat
    return d2 + soar_lambda * par * par


def assign_partitions(x, centroids, eta: float = 1.0,
                      soar_lambda: float = 1.0):
    """Primary + SOAR secondary partition per point. Returns (p1, p2) [N]."""
    p1 = _nearest(x, centroids, eta)

    def secondary(rows):
        xb, pb = x[rows], p1[rows]
        soar = soar_cost(xb, centroids, _pairwise_sq_dist(xb, centroids), pb,
                         soar_lambda)
        soar[torch.arange(xb.shape[0], device=x.device), pb] = float("inf")
        return soar.argmin(-1)
    return p1, _blocked_argmin(x.shape[0], centroids.shape[0], secondary)


def assign_block(x, centroids, soar_lambda: float = -1.0):
    """Primary (plain L2) and SOAR secondary partition of every row of
    ``x`` inside one block of ``centroids``: local ids (p1, p2) int64 [N],
    ``p2 = -1`` when ``soar_lambda < 0``. The sharded mutate step
    (``ann/sharded.py``) runs it on each shard's block and
    ``assign_partitions_local`` on each owner's, so that on the same
    tensors the host mirror and the device placement agree bit for bit."""
    d2 = _pairwise_sq_dist(x, centroids)
    p1 = d2.argmin(-1)
    if soar_lambda < 0:
        return p1, torch.full_like(p1, -1)
    soar = soar_cost(x, centroids, d2, p1, soar_lambda)
    soar[torch.arange(x.shape[0], device=x.device), p1] = float("inf")
    return p1, soar.argmin(-1)


def assign_partitions_local(x, centroids, owners, *, c_loc: int,
                            soar_lambda: float = -1.0):
    """``assign_partitions`` restricted to each point's owner block.

    The sharded mutate path hash-routes every point to an owner shard that
    holds ``c_loc`` consecutive partitions; primary and SOAR secondary are
    chosen inside that block (write amplification stays shard-local).
    This is the host mirror of the mutate step's assignment, the same
    plain-L2 primary cost and SOAR secondary cost (``assign_block`` on
    the slice ``centroids[o * c_loc:(o + 1) * c_loc]`` of each owner
    ``o``). ``soar_lambda < 0`` disables the secondary (``p2 = -1``).
    Returns ``(p1, p2)`` int64 [N] global ids."""
    p1 = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    p2 = torch.full_like(p1, -1)
    for blk in range(centroids.shape[0] // c_loc):
        lo = blk * c_loc
        b1, b2 = assign_block(x, centroids[lo:lo + c_loc], soar_lambda)
        mine = owners == blk
        p1 = torch.where(mine, b1 + lo, p1)
        if soar_lambda >= 0:
            p2 = torch.where(mine, b2 + lo, p2)
    return p1, p2


def partition_scores(q: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Query-to-partition dot scores [B, C] (higher = search first)."""
    return q @ centroids.T


def quantized_partition_sizes(p1: np.ndarray, p2: np.ndarray,
                              n_clusters: int) -> np.ndarray:
    """Copies per partition: the primary and the SOAR secondary counts."""
    return (np.bincount(np.asarray(p1), minlength=n_clusters)
            + np.bincount(np.asarray(p2), minlength=n_clusters))
