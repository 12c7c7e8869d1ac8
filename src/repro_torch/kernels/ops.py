"""Public entry points for the ported kernels (port of
``repro/kernels/ops.py``), with the reference's names and contracts.

Each entry point launches its CUDA kernel when its inputs lie on the card
and runs the kernel's plain PyTorch version when they lie on the CPU; it
never falls back from the card to the plain version.

Not ported yet (they raise ``NotImplementedError`` where a caller asks for
them): the int8 fused shortlist (``quantized=True``), ``pq_score`` /
``pq_score_batched`` / ``pq_scores`` (the ``fused=False`` path) and
``topk_select`` (the maintained graph).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_query as _fq
from repro_torch.kernels import scorer_mlp as _mlp
from repro_torch.kernels import sparse_dot as _sd

KERNELS = {"fused_query": _fq.fused_query_kernel,
           "sparse_dot_batched": _sd.sparse_dot_batched,
           "sparse_dot": _sd.sparse_dot,
           "scorer_mlp": _mlp.scorer_mlp}


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
    if quantized:
        raise NotImplementedError(
            "the int8 fused shortlist (repro/kernels/fused_query.py::"
            "fused_query_kernel_int8) is not ported yet")
    b, n = codes.shape[0], codes.shape[1]
    dev = lut.device
    valid = (torch.ones((b, n), dtype=torch.bool, device=dev) if valid is None
             else valid.to(torch.bool))
    bias = (torch.zeros((b, n), dtype=torch.float32, device=dev)
            if bias is None else bias.to(torch.float32))
    return _fq.fused_query_kernel(lut, codes, _as_int32_bits(ids), valid,
                                  bias, k)


def sparse_dot(q_idx, q_val, db_idx, db_val) -> torch.Tensor:
    """Exact sparse-sparse scores: q [B,Kq] vs db [N,Kd] -> f32 [B, N]."""
    return _sd.sparse_dot(q_idx, q_val, db_idx, db_val)


def sparse_dot_batched(q_idx, q_val, db_idx, db_val) -> torch.Tensor:
    """Shortlist rescoring: q [B,Kq] vs db [B,R,Kd] -> f32 [B, R]."""
    return _sd.sparse_dot_batched(q_idx, q_val, db_idx, db_val)


def scorer_mlp(feats, params: dict) -> torch.Tensor:
    """Fused paper-scorer: feats [B, F] + core.scorer params -> f32 [B]."""
    return _mlp.scorer_mlp(feats, params["w0"], params["b0"], params["w1"],
                           params["b1"], params["w2"], params["b2"])
