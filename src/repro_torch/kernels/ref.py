"""Plain-PyTorch oracles for the ported kernels (port of
``repro/kernels/ref.py``).

These are the semantic ground truth: each kernel module builds its plain
version from them, the CPU tests hold them against the reference's
oracles, and the card tests hold each CUDA kernel against them.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PAD_INDEX


def topk_ref(scores: torch.Tensor, k: int):
    """Row-wise top-k (values, indices) of f32 scores in ``lax.top_k``'s
    order: descending, +0.0 above -0.0, equal scores (-inf included) by
    the lowest index, each entry with its own value. ``torch.topk`` does
    not promise that order at ties, and a stable sort on the floats ties
    -0.0 with +0.0: the stable sort runs on the order-preserving int32
    image of the bits (``b ^ 0x7FFFFFFF`` where the sign bit is set)."""
    if scores.dtype != torch.float32:
        raise TypeError(f"scores must be f32, got {scores.dtype}")
    bits = scores.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    _, idxs = torch.sort(key, dim=-1, descending=True, stable=True)
    idxs = idxs[..., :k]
    return torch.gather(scores, -1, idxs), idxs


def sparse_dot_ref(q_idx, q_val, db_idx, db_val) -> torch.Tensor:
    """Padded sparse-sparse scores. q [B,Kq], db [N,Kd] -> [B, N]."""
    eq = (q_idx[:, None, :, None] == db_idx[None, :, None, :]) \
        & (q_idx[:, None, :, None] != PAD_INDEX)
    prod = q_val[:, None, :, None].float() * db_val[None, :, None, :].float()
    return torch.where(eq, prod, 0.0).sum((2, 3))


def sparse_dot_batched_ref(q_idx, q_val, db_idx, db_val) -> torch.Tensor:
    """Per-query rows: q [B,Kq] vs db [B,R,Kd] -> [B, R]."""
    eq = (q_idx[:, None, :, None] == db_idx[:, :, None, :]) \
        & (q_idx[:, None, :, None] != PAD_INDEX)
    prod = q_val[:, None, :, None].float() * db_val[:, :, None, :].float()
    return torch.where(eq, prod, 0.0).sum((2, 3))


def scorer_mlp_ref(feats, w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """Fused 2-hidden-layer tanh MLP + sigmoid head. feats [B,F] -> [B]."""
    h = torch.tanh(feats.float() @ w0.float() + b0)
    h = torch.tanh(h @ w1.float() + b1)
    return torch.sigmoid((h @ w2.float() + b2)[..., 0])


def pq_score_seq_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Ordered (left-to-right over subspaces) LUT accumulation — the
    bitwise contract of the fused-query kernel's scoring stage.
    lut f32 [B, M, C]; codes u8 [B, N, M] -> [B, N]."""
    acc = torch.zeros(codes.shape[:2], dtype=torch.float32, device=lut.device)
    for mi in range(lut.shape[1]):
        acc = acc + torch.gather(lut[:, mi, :], 1, codes[:, :, mi].long())
    return acc


def shortlist_dedup_ref(vals, idxs, ids, valid):
    """Dedup-after-cut: shortlist entry i becomes -inf iff some earlier
    entry j < i selected the same point id with both slots valid.
    ``idxs`` are untouched so gathers stay aligned."""
    sid = torch.gather(ids, 1, idxs)
    sv = torch.gather(valid, 1, idxs)
    same = (sid[:, :, None] == sid[:, None, :]) & sv[:, :, None] & sv[:, None, :]
    k = vals.shape[1]
    ar = torch.arange(k, device=vals.device)
    earlier = ar[None, :, None] > ar[None, None, :]
    dup = (same & earlier).any(2)
    return torch.where(dup, float("-inf"), vals)
