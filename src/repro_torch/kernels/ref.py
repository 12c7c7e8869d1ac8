"""Plain-PyTorch oracles for the ported kernels (port of
``repro/kernels/ref.py``).

These are the semantic ground truth: each kernel module builds its plain
version from them, the CPU tests hold them against the reference's
oracles, and the card tests hold each CUDA kernel against them.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PAD_INDEX, PAD_ITEM

# feature group kinds of a pair (``pair_features_ref``, the pair-score
# kernel) and the dtype of their fields
DENSE, SET, SCALAR = 0, 1, 2
FIELD_DTYPES = {DENSE: torch.float32, SET: torch.int32, SCALAR: torch.float32}


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


def sparse_dot_batched_ref(q_idx, q_val, db_idx, db_val) -> torch.Tensor:
    """Per-query rows: q [B,Kq] vs db [B,R,Kd] -> [B, R]."""
    eq = (q_idx[:, None, :, None] == db_idx[:, :, None, :]) \
        & (q_idx[:, None, :, None] != PAD_INDEX)
    prod = q_val[:, None, :, None].float() * db_val[:, :, None, :].float()
    return torch.where(eq, prod, 0.0).sum((2, 3))


def sparse_dot_seq_ref(q_idx, q_val, db_idx, db_val) -> torch.Tensor:
    """Per-query rows in the sparse-dot kernels' order (their bitwise
    contract; a shared db is broadcast over B): db entry j outer, query
    entry i inner, one rounded product and one rounded add each; a
    non-match adds +0.0, which leaves a sum that starts at +0.0 unchanged.
    q [B,Kq] vs db [B,R,Kd] -> [B, R]."""
    acc = torch.zeros(db_idx.shape[:2], dtype=torch.float32,
                      device=q_val.device)
    live = q_idx != PAD_INDEX
    for j in range(db_idx.shape[2]):
        dj, dv = db_idx[:, :, j], db_val[:, :, j].float()
        for i in range(q_idx.shape[1]):
            hit = (q_idx[:, i:i + 1] == dj) & live[:, i:i + 1]
            acc = acc + torch.where(hit, q_val[:, i:i + 1].float() * dv, 0.0)
    return acc


def pair_features_ref(qa: list, cb: list, kinds) -> torch.Tensor:
    """Per-pair similarity signals f32 [P, F] of aligned rows (the
    formulas of ``repro/core/scorer.py::pair_features``): per group of
    ``kinds`` (``DENSE``: cosine and scaled L2; ``SET``: Jaccard and
    log1p of the overlap; ``SCALAR``: minus the absolute difference),
    ``qa[g]``/``cb[g]`` the group's two sides."""
    feats = []
    for a, b, kind in zip(qa, cb, kinds):
        if kind == DENSE:
            na = torch.linalg.norm(a, dim=-1) + 1e-9
            nb = torch.linalg.norm(b, dim=-1) + 1e-9
            feats.append((a * b).sum(-1) / (na * nb))                 # cosine
            feats.append(-torch.linalg.norm(a - b, dim=-1) / (na + nb))
        elif kind == SET:
            va, vb = a != PAD_ITEM, b != PAD_ITEM
            inter = ((a[:, :, None] == b[:, None, :]) & va[:, :, None]
                     & vb[:, None, :]).sum((1, 2)).to(torch.float32)
            size_a = va.sum(-1).to(torch.float32)
            size_b = vb.sum(-1).to(torch.float32)
            union = (size_a + size_b - inter).clamp(min=1.0)
            feats.append(inter / union)                                # Jaccard
            feats.append(torch.log1p(inter))                           # overlap
        elif kind == SCALAR:
            feats.append(-(a - b).abs())
        else:
            raise ValueError(f"unknown feature group kind {kind}")
    return torch.stack(feats, -1)


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
    ``idxs`` are untouched so gathers stay aligned. A stable sort by id
    puts each id's entries together in shortlist order; an entry is a
    duplicate when a valid entry precedes it in its group (O(k log k) a
    row, where comparing every pair would take k^2)."""
    sid = torch.gather(ids, 1, idxs)
    sv = torch.gather(valid, 1, idxs)
    order = torch.sort(sid, dim=1, stable=True).indices
    s_id = torch.gather(sid, 1, order)
    s_v = torch.gather(sv, 1, order).to(torch.int64)
    k = vals.shape[1]
    pos = torch.arange(k, device=vals.device).expand_as(s_id)
    first = torch.ones_like(s_id, dtype=torch.bool)
    first[:, 1:] = s_id[:, 1:] != s_id[:, :-1]
    # valid entries before each one in its row, and before its group
    before = s_v.cumsum(1) - s_v
    start = torch.where(first, pos, 0).cummax(1).values
    dup_sorted = (s_v > 0) & (before > torch.gather(before, 1, start))
    dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    return torch.where(dup, float("-inf"), vals)
