"""Product quantization with the anisotropic (score-aware) loss (port of
``repro/ann/quantize.py``).

Residuals are split into M subspaces with a 256-center codebook each.
Codebook training solves, per center, the (d_sub x d_sub) normal equations

    (n I + (eta-1) * sum_i x̂_i x̂_iᵀ) c = sum_i x_i + (eta-1) sum_i x̂_i x̂_iᵀ x_i

with one batched ``torch.linalg.solve``. Query-time scoring is LUT-based:
lut[m, c] = q_m . codebook[m, c]; the LUT sum over a point's codes runs in
the fused shortlist kernel (``kernels/fused_query.py``).
"""
from __future__ import annotations

import torch

from repro_torch.ann.partition import sample_rows, segment_sum


def split_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """[N, d] -> [N, M, d/M]."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"d_proj {d} must divide into {m} subspaces")
    return x.reshape(n, m, d // m)


def _aniso_center_update(x, xhat, assign, centers, eta: float):
    """Exact per-center anisotropic solve in one subspace.
    x, xhat: [N, ds]; assign: [N] center ids; centers: [C, ds]."""
    c, ds = centers.shape
    lengths = torch.bincount(assign, minlength=c)
    n_per = lengths.to(x.dtype)                                      # [C]
    sum_x = segment_sum(x, assign, lengths)                          # [C, ds]
    if eta == 1.0:
        return torch.where(n_per[:, None] > 0,
                           sum_x / n_per.clamp(min=1.0)[:, None], centers)
    outer = xhat[:, :, None] * xhat[:, None, :]                      # [N, ds, ds]
    A = segment_sum(outer, assign, lengths)                          # [C, ds, ds]
    proj = (xhat * x).sum(-1)                                        # [N]
    b2 = segment_sum(xhat * proj[:, None], assign, lengths)
    eye = torch.eye(ds, dtype=x.dtype, device=x.device)
    lhs = n_per[:, None, None] * eye + (eta - 1.0) * A
    rhs = sum_x + (eta - 1.0) * b2
    solved = torch.linalg.solve(lhs + 1e-6 * eye, rhs[:, :, None])[:, :, 0]
    return torch.where(n_per[:, None] > 0, solved, centers)


def train_codebooks(residuals: torch.Tensor, m: int, n_centers: int = 256,
                    iters: int = 10, eta: float = 1.0,
                    seed: int = 0) -> torch.Tensor:
    """Train per-subspace codebooks. Returns f32 [M, n_centers, ds]."""
    sub = split_subspaces(residuals, m)                               # [N, M, ds]
    init = sample_rows(sub.shape[0], n_centers, seed, residuals.device)
    books = sub[init].permute(1, 0, 2).contiguous()                   # [M, C, ds]
    # the direction of the *full* residual drives the anisotropic weight;
    # per subspace, the subspace component of the unit residual is used
    norm = torch.linalg.norm(residuals, dim=-1, keepdim=True) + 1e-9
    xhat_sub = split_subspaces(residuals / norm, m)
    for _ in range(iters):
        new_books = []
        for mi in range(m):
            x, xh, centers = sub[:, mi], xhat_sub[:, mi], books[mi]
            d2 = ((x * x).sum(-1)[:, None] - 2 * x @ centers.T
                  + (centers * centers).sum(-1)[None, :])
            if eta != 1.0:
                par = (x * xh).sum(-1)[:, None] - xh @ centers.T
                d2 = d2 + (eta - 1.0) * par * par
            new_books.append(_aniso_center_update(x, xh, d2.argmin(-1),
                                                  centers, eta))
        books = torch.stack(new_books)
    return books


def encode(residuals: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """Assign codes u8 [N, M] (nearest center per subspace, L2)."""
    sub = split_subspaces(residuals, books.shape[0])                  # [N, M, ds]
    d2 = ((sub * sub).sum(-1)[:, :, None]
          - 2 * torch.einsum("nmd,mcd->nmc", sub, books)
          + (books * books).sum(-1)[None, :, :])
    return d2.argmin(-1).to(torch.uint8)


def query_lut(q: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """LUT f32 [B, M, n_centers]: dot of each query subvector w/ each center."""
    q_sub = split_subspaces(q, books.shape[0])                        # [B, M, ds]
    return torch.einsum("bmd,mcd->bmc", q_sub, books).contiguous()


def lut_scores(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain LUT accumulation: lut [M, C] x codes [N, M] -> scores [N]
    (the oracle of the ``pq_score`` kernel, not the kernel)."""
    m = lut.shape[0]
    per_sub = lut[torch.arange(m, device=lut.device)[None, :], codes.long()]
    return per_sub.sum(-1)
