"""Exact sparse-sparse dot products: one CUDA source for two TPU kernels
and the index's rescore step.

Port of the Pallas kernels ``repro/kernels/sparse_dot.py::
sparse_dot_batched`` (per-query rows: the shortlist rescore) and
``::sparse_dot`` (one db for every query: the brute-force index). The
CUDA source is ``csrc/sparse_dot.cu``, which notes each kernel's design
and bound: the shared form reads each db tile once and looks its indices
up in a hash table of the queries' indices, and can mask rows (``valid``)
so that the brute index's search needs no pass of its own.

``sparse_rescore_topk`` is ``sparse_dot_batched`` redesigned with what
surrounds it on the index's path (``repro/ann/scann.py:126-144``): the
shortlist's slots, the slab rows, the exact sparse dot, the mask and the
final top-k in one launch. Every form gives bitwise the results of its
plain version: the kernels sum in the order of ``ref.sparse_dot_seq_ref``,
and the rescore's top-k is ``lax.top_k``'s order (``ref.topk_ref``).

Indices are uint32 values in int64 tensors (``core/types.py``); the
kernels read them through an int32 view without a copy. Each wrapper runs
its plain version for CPU tensors and counts its launches in
``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sparse_dot_seq_ref, topk_ref
from repro_torch.kernels.topk_select import CHUNK, chunk_plan

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SHARED_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p])
_RESCORE_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong]
                     + [ctypes.c_int] * 8 + [ctypes.c_void_p])
# the longest shortlist the rescore sorts in one block (a row of two
# chunks of the top-k kernels, whole); longer ones go through a [B, r]
# scratch of keys and the split top-k
MAX_REORDER = 2 * CHUNK
# db rows per plain-version chunk: bounds its [B, rows, Kq, Kd] temporaries
_PLAIN_ELEMS = 1 << 24


def sparse_dot_plain(q_idx, q_val, db_idx, db_val, valid=None
                     ) -> torch.Tensor:
    """Plain version of both forms: db [N, Kd] (shared) or [B, R, Kd],
    summed in the kernels' order (``sparse_dot_seq_ref``, the shared db
    broadcast over the queries), so they agree with the kernels bit for
    bit; a shared db's rows where ``valid`` is False score -inf."""
    if db_idx.dim() == 3:
        return sparse_dot_seq_ref(q_idx, q_val, db_idx, db_val)
    b, kq = q_idx.shape
    n, kd = db_idx.shape
    step = max(1, _PLAIN_ELEMS // max(b * kq * kd, 1))
    out = torch.cat([sparse_dot_seq_ref(
        q_idx, q_val, db_idx[None, lo:lo + step].expand(b, -1, -1),
        db_val[None, lo:lo + step].expand(b, -1, -1))
        for lo in range(0, n, step)] or
        [torch.zeros((b, 0), device=q_val.device)], dim=1)
    if valid is not None:
        out = torch.where(valid[None, :], out, float("-inf"))
    return out


def _check(tensors: dict, dev: torch.device, what: str) -> None:
    """name -> (tensor, dtype): raise unless each has its dtype on dev."""
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")


def _operands(q_idx, q_val, db_idx, db_val, what: str) -> list:
    """The four operands checked and contiguous (copied only if not)."""
    _check({"q_idx": (q_idx, torch.int64), "q_val": (q_val, torch.float32),
            "db_idx": (db_idx, torch.int64),
            "db_val": (db_val, torch.float32)}, q_idx.device, what)
    if q_val.shape != q_idx.shape or db_val.shape != db_idx.shape:
        raise ValueError(f"{what}: values {tuple(q_val.shape)}/"
                         f"{tuple(db_val.shape)} do not match indices "
                         f"{tuple(q_idx.shape)}/{tuple(db_idx.shape)}")
    # the kernels read the low 32-bit word of each int64 index
    return [t.contiguous() for t in (q_idx, q_val, db_idx, db_val)]


def sparse_dot_batched(q_idx, q_val, db_idx, db_val) -> torch.Tensor:
    """Shortlist rescore: q [B, Kq] vs db [B, R, Kd] -> f32 [B, R]."""
    if db_idx.dim() != 3 or db_idx.shape[0] != q_idx.shape[0]:
        raise ValueError(f"db must be [B, R, Kd], got {tuple(db_idx.shape)}")
    if _build.device_kind(q_idx, "sparse_dot_batched") == "cpu":
        return sparse_dot_plain(q_idx, q_val, db_idx, db_val)
    args = _operands(q_idx, q_val, db_idx, db_val, "sparse_dot_batched")
    b, kq = q_idx.shape
    r, kd = db_idx.shape[1], db_idx.shape[2]
    out = torch.empty((b, r), dtype=torch.float32, device=q_idx.device)
    launch = _build.function("sparse_dot", "sparse_dot_launch", _ARGTYPES)
    code = launch(*[t.data_ptr() for t in args], out.data_ptr(), b, r, kq,
                  kd, q_idx.device.index, _build.stream_of(q_idx))
    _build.check(code, "sparse_dot", "sparse_dot_batched launch")
    sparse_dot_batched.launches += 1
    return out


def sparse_dot(q_idx, q_val, db_idx, db_val, valid=None) -> torch.Tensor:
    """Shared db (brute force): q [B, Kq] vs db [N, Kd] -> f32 [B, N];
    with ``valid`` (bool [N]) the rows where it is False score -inf."""
    if db_idx.dim() != 2:
        raise ValueError(f"db must be [N, Kd], got {tuple(db_idx.shape)}")
    n = db_idx.shape[0]
    if valid is not None and (valid.dtype != torch.bool
                              or tuple(valid.shape) != (n,)):
        raise ValueError(f"sparse_dot: valid must be bool [{n}], got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if _build.device_kind(q_idx, "sparse_dot") == "cpu":
        return sparse_dot_plain(q_idx, q_val, db_idx, db_val, valid)
    args = _operands(q_idx, q_val, db_idx, db_val, "sparse_dot")
    if valid is not None:
        _check({"valid": (valid, torch.bool)}, q_idx.device, "sparse_dot")
        args.append(valid.contiguous())
    b, kq = q_idx.shape
    out = torch.empty((b, n), dtype=torch.float32, device=q_idx.device)
    launch = _build.function("sparse_dot", "sparse_dot_shared_launch",
                             _SHARED_ARGTYPES)
    code = launch(*[t.data_ptr() for t in args[:4]],
                  None if valid is None else args[4].data_ptr(),
                  out.data_ptr(), b, n, kq, db_idx.shape[1],
                  q_idx.device.index, _build.stream_of(q_idx))
    _build.check(code, "sparse_dot", "sparse_dot launch")
    sparse_dot.launches += 1
    return out


def sparse_rescore_topk_plain(q_idx, q_val, flat_slots, short_pos,
                              short_scores, sp_idx, sp_val, k: int):
    """The plain PyTorch version, same arguments as the kernel: the
    composition the index ran before the kernel took it over."""
    short_slots = torch.gather(flat_slots, 1, short_pos.long())
    # -inf = invalid or duplicate SOAR copy; both drop out of the rescore
    short_slots = torch.where(torch.isfinite(short_scores), short_slots, -1)
    safe = short_slots.clamp(min=0).long()
    exact = sparse_dot_seq_ref(q_idx, q_val, sp_idx[safe], sp_val[safe])
    exact = torch.where(short_slots >= 0, exact, float("-inf"))
    final_scores, pos = topk_ref(exact, min(k, exact.shape[1]))
    final_slots = torch.gather(short_slots, 1, pos)
    final_slots = torch.where(torch.isfinite(final_scores), final_slots, -1)
    return final_slots, -final_scores


def sparse_rescore_topk(q_idx, q_val, flat_slots, short_pos, short_scores,
                        sp_idx, sp_val, k: int):
    """The index's rescore step: q_idx i64 [B, Kq], q_val f32 [B, Kq];
    flat_slots i32 [B, N] (the probed slabs' slots); the shortlist
    short_pos i32 [B, r] (positions in flat_slots) and short_scores f32
    [B, r] (-inf: out); the slab sp_idx i64 [cap, Kd], sp_val f32
    [cap, Kd] -> (final_slots i32 [B, k'], dists f32 [B, k']), k' =
    min(k, r): the shortlist's top k' by exact score, slot -1 and dist +inf
    where the score is -inf, dist = -score.

    On the card a shortlist of at most ``MAX_REORDER`` entries is one
    launch (one block a row sorts it whole); a longer one computes the
    same keys tile by tile into a [B, r] scratch and selects from them
    with the split top-k of ``topk_select`` (``chunk_plan``), in the same
    order. Both are one call of the wrapper."""
    b, kq = q_idx.shape
    r = short_pos.shape[1]
    if (q_val.shape != q_idx.shape or flat_slots.dim() != 2
            or flat_slots.shape[0] != b
            or tuple(short_pos.shape) != (b, r)
            or short_scores.shape != short_pos.shape
            or sp_val.shape != sp_idx.shape or sp_idx.dim() != 2):
        raise ValueError(
            f"sparse_rescore_topk: shapes q {tuple(q_idx.shape)}/"
            f"{tuple(q_val.shape)}, flat_slots {tuple(flat_slots.shape)}, "
            f"shortlist {tuple(short_pos.shape)}/{tuple(short_scores.shape)}"
            f", slab {tuple(sp_idx.shape)}/{tuple(sp_val.shape)}")
    if r < 1 or k < 1:
        raise ValueError(f"sparse_rescore_topk: r={r} and k={k} must be "
                         f">= 1")
    if _build.device_kind(q_idx, "sparse_rescore_topk") == "cpu":
        return sparse_rescore_topk_plain(q_idx, q_val, flat_slots, short_pos,
                                         short_scores, sp_idx, sp_val, k)
    # the slots are int32, so are the counts; a long shortlist's keys pass
    # takes the rows on its grid's y dimension
    _build.check_int32("sparse_rescore_topk", B=b, N=flat_slots.shape[1],
                       slab_rows=sp_idx.shape[0])
    if r > MAX_REORDER and b > _build.GRID_Y_MAX:
        raise ValueError(f"sparse_rescore_topk: B={b} rows past "
                         f"{_build.GRID_Y_MAX} with a shortlist of {r}")
    dev = q_idx.device
    tensors = {"q_idx": (q_idx, torch.int64), "q_val": (q_val, torch.float32),
               "flat_slots": (flat_slots, torch.int32),
               "short_pos": (short_pos, torch.int32),
               "short_scores": (short_scores, torch.float32),
               "sp_idx": (sp_idx, torch.int64),
               "sp_val": (sp_val, torch.float32)}
    _check(tensors, dev, "sparse_rescore_topk")
    args = [t.contiguous() for t, _ in tensors.values()]
    kk = min(k, r)
    slots = torch.empty((b, kk), dtype=torch.int32, device=dev)
    dists = torch.empty((b, kk), dtype=torch.float32, device=dev)
    chunk, words = chunk_plan(r, kk)
    # above MAX_REORDER: keys [B, r], the split's survivors, slots [B, r]
    words = b * (r + words) + (b * r + 1) // 2 if r > MAX_REORDER else 0
    scratch = (torch.empty(words, dtype=torch.int64, device=dev)
               if words else None)
    launch = _build.function("sparse_dot", "sparse_rescore_topk_launch",
                             _RESCORE_ARGTYPES)
    code = launch(*[t.data_ptr() for t in args], slots.data_ptr(),
                  dists.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), words, b,
                  flat_slots.shape[1], r, kq, sp_idx.shape[1], kk, chunk,
                  dev.index, _build.stream_of(q_idx))
    _build.check(code, "sparse_dot", "sparse_rescore_topk launch")
    sparse_rescore_topk.launches += 1
    return slots, dists


sparse_dot_batched.launches = 0
sparse_dot.launches = 0
sparse_rescore_topk.launches = 0
