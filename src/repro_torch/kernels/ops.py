"""Public entry points for the ported kernels (port of
``repro/kernels/ops.py``), with the reference's names and contracts.

Each entry point launches its CUDA kernel when its inputs lie on the card
and runs the kernel's plain PyTorch version when they lie on the CPU; it
never falls back from the card to the plain version. The reference's
``use_kernel`` / ``interpret`` switches have no counterpart: the device
decides. ``dedup_mask`` is XLA in the reference, not Pallas, and stays
plain PyTorch here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import buckets as _bk
from repro_torch.kernels import fused_query as _fq
from repro_torch.kernels import pq_score as _pq
from repro_torch.kernels import scorer_mlp as _mlp
from repro_torch.kernels import sketch as _sk
from repro_torch.kernels import sparse_dot as _sd
from repro_torch.kernels import topk_select as _tk
from repro_torch.kernels.ref import shortlist_dedup_ref

KERNELS = {"fused_query": _fq.fused_query_kernel,
           "fused_query_int8": _fq.fused_query_kernel_int8,
           "sparse_dot_batched": _sd.sparse_dot_batched,
           "sparse_rescore_topk": _sd.sparse_rescore_topk,
           "sparse_dot": _sd.sparse_dot,
           "scorer_mlp": _mlp.scorer_mlp,
           "pair_score": _mlp.pair_score,
           "topk_select": _tk.topk_select,
           "pq_score_batched": _pq.pq_score_batched,
           "pq_score": _pq.pq_score,
           "simhash_scalar_columns": _bk.simhash_scalar_columns,
           "minhash_columns": _bk.minhash_columns,
           "count_sketch": _sk.count_sketch}

quantize_lut = _fq.quantize_lut
PairLayout = _mlp.PairLayout


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _as_int32_bits(ids: torch.Tensor) -> torch.Tensor:
    """Any integer ids -> int32 with uint32 wraparound (dedup compares
    equality only, so wrapped ids stay equal exactly when they were)."""
    if ids.dtype == torch.int32:
        return ids
    ids = ids.to(torch.int64) & 0xFFFFFFFF
    return torch.where(ids >= 2 ** 31, ids - 2 ** 32, ids).to(torch.int32)


def pq_score_dedup_topk(lut, codes, ids, k: int, *, valid=None, bias=None,
                        quantized: bool = False):
    """Fused query shortlist: PQ-LUT scores (+bias), invalid rows -> -inf,
    top-k with the lowest-index tie-break, SOAR dedup-after-cut.

    lut f32 [B, M, C]; codes u8 [B, N, M]; ids [B, N] (any integer dtype)
    -> (vals f32 [B, k], idxs i32 [B, k]). See kernels/fused_query.py.
    """
    b, n = codes.shape[0], codes.shape[1]
    dev = lut.device
    valid = (torch.ones((b, n), dtype=torch.bool, device=dev) if valid is None
             else valid.to(torch.bool))
    bias = (torch.zeros((b, n), dtype=torch.float32, device=dev)
            if bias is None else bias.to(torch.float32))
    if quantized:
        qlut, scale = _fq.quantize_lut(lut)
        return _fq.fused_query_kernel_int8(qlut, scale, codes,
                                           _as_int32_bits(ids), valid, bias, k)
    return _fq.fused_query_kernel(lut, codes, _as_int32_bits(ids), valid,
                                  bias, k)


def pq_score(lut, codes) -> torch.Tensor:
    """LUT scoring: lut f32 [B, M, C]; codes u8 [N, M] -> f32 [B, N]."""
    return _pq.pq_score(lut, codes)


def pq_score_batched(lut, codes) -> torch.Tensor:
    """Per-query slabs: lut f32 [B, M, C]; codes u8 [B, N, M] -> [B, N]."""
    return _pq.pq_score_batched(lut, codes)


def pq_scores(lut, codes, *, quantized: bool = False) -> torch.Tensor:
    """Raw shortlist scores with the fused path's ordering contract:
    lut f32 [B, M, C]; codes u8 [B, N, M] -> f32 [B, N]. The quantised
    form dequantises the int8 table in torch (one product per entry, as
    the reference's twin does) and scores it with the same kernel."""
    if quantized:
        lut = _fq.dequantize_lut(*_fq.quantize_lut(lut))
    return _pq.pq_score_batched(lut, codes)


def topk_select(scores, k: int):
    """Row-wise top-k (vals f32, idxs i32), lowest index first at ties, in
    the reference's two orders: its Pallas kernel's at k <= 64 (-0.0 ties
    +0.0) and ``lax.top_k``'s above (+0.0 first). Both run on the kernel."""
    return _tk.topk_select(scores, k, signed_zeros=k > 64)


def dedup_mask(vals, idxs, ids, valid) -> torch.Tensor:
    """SOAR dedup over a cut shortlist: -inf the later of any two valid
    entries sharing a point id. vals/idxs [B, k]; ids/valid [B, N]."""
    return shortlist_dedup_ref(vals, idxs.long(), ids, valid.to(torch.bool))


def sparse_dot(q_idx, q_val, db_idx, db_val, valid=None) -> torch.Tensor:
    """Exact sparse-sparse scores: q [B,Kq] vs db [N,Kd] -> f32 [B, N];
    -inf in the columns where the optional row mask ``valid`` is False."""
    return _sd.sparse_dot(q_idx, q_val, db_idx, db_val, valid)


def sparse_dot_batched(q_idx, q_val, db_idx, db_val) -> torch.Tensor:
    """Shortlist rescoring: q [B,Kq] vs db [B,R,Kd] -> f32 [B, R]."""
    return _sd.sparse_dot_batched(q_idx, q_val, db_idx, db_val)


def sparse_rescore_topk(q_idx, q_val, flat_slots, short_pos, short_scores,
                        sp_idx, sp_val, k: int):
    """The index's exact rescore and final top-k in one launch: shortlist
    slots flat_slots[b, short_pos] (-1 where short_scores is -inf), the
    exact sparse dot of each with the query row, then the top
    k' = min(k, r) in ``lax.top_k``'s order -> (final_slots i32 [B, k'],
    dists f32 [B, k'] = -score; -1 / +inf where the score is -inf)."""
    return _sd.sparse_rescore_topk(q_idx, q_val, flat_slots, short_pos,
                                   short_scores, sp_idx, sp_val, k)


def scorer_mlp(feats, params: dict) -> torch.Tensor:
    """Fused paper-scorer: feats [B, F] + core.scorer params -> f32 [B]."""
    return _mlp.scorer_mlp(feats, *_mlp_weights(params))


def pair_score(params: dict, q_fields, c_fields, layout, group: int
               ) -> torch.Tensor:
    """Pair features and the scorer MLP in one launch: pair p is candidate
    row p of ``c_fields`` against query row ``p // group`` of ``q_fields``
    (one tensor per group of the ``PairLayout``) -> f32 [P]."""
    return _mlp.pair_score(q_fields, c_fields, layout, group,
                           *_mlp_weights(params))


def _mlp_weights(params: dict) -> list:
    return [params[name] for name in ("w0", "b0", "w1", "b1", "w2", "b2")]
