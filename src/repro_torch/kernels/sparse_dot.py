"""Exact sparse-sparse dot products: one CUDA kernel for two TPU kernels.

Port of the Pallas kernels ``repro/kernels/sparse_dot.py::
sparse_dot_batched`` (per-query rows: the shortlist rescore) and
``::sparse_dot`` (one db for every query: the brute-force index). The
CUDA source is ``csrc/sparse_dot.cu``; it takes the shared form as a db
batch stride of 0 and notes its design and bound.

Indices are uint32 values in int64 tensors (``core/types.py``); the
kernel reads them through an int32 view without a copy. Each wrapper runs
its plain version for CPU tensors and counts its launches in
``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sparse_dot_batched_ref, sparse_dot_ref

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_longlong, ctypes.c_void_p])
# db rows per plain-version chunk: bounds its [B, rows, Kq, Kd] temporaries
_PLAIN_ELEMS = 1 << 24


def sparse_dot_plain(q_idx, q_val, db_idx, db_val) -> torch.Tensor:
    """Plain version of both forms: db [N, Kd] (shared) or [B, R, Kd]."""
    if db_idx.dim() == 3:
        return sparse_dot_batched_ref(q_idx, q_val, db_idx, db_val)
    b, kq = q_idx.shape
    n, kd = db_idx.shape
    step = max(1, _PLAIN_ELEMS // max(b * kq * kd, 1))
    return torch.cat([sparse_dot_ref(q_idx, q_val, db_idx[lo:lo + step],
                                     db_val[lo:lo + step])
                      for lo in range(0, n, step)] or
                     [torch.zeros((b, 0), device=q_val.device)], dim=1)


def _launch(q_idx, q_val, db_idx, db_val, rows: int, batch_rows: int,
            what: str) -> torch.Tensor:
    b, kq = q_idx.shape
    kd = db_idx.shape[-1]
    tensors = [t.contiguous() for t in (q_idx, q_val, db_idx, db_val)]
    for t, dtype in zip(tensors, (torch.int64, torch.float32) * 2):
        if t.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
        if t.device != q_idx.device:
            raise ValueError(f"{what}: tensors on {t.device} and "
                             f"{q_idx.device}")
    out = torch.empty((b, rows), dtype=torch.float32, device=q_idx.device)
    # the kernel reads the low 32-bit word of each int64 index
    views = [tensors[0].view(torch.int32), tensors[1],
             tensors[2].view(torch.int32), tensors[3]]
    launch = _build.function("sparse_dot", "sparse_dot_launch", _ARGTYPES)
    with torch.cuda.device(q_idx.device):
        code = launch(*map(_build.ptr, views), _build.ptr(out), b, rows, kq,
                      kd, batch_rows, _build.stream_of(q_idx))
    _build.check(code, "sparse_dot", f"{what} launch")
    return out


def sparse_dot_batched(q_idx, q_val, db_idx, db_val) -> torch.Tensor:
    """Shortlist rescore: q [B, Kq] vs db [B, R, Kd] -> f32 [B, R]."""
    if db_idx.dim() != 3 or db_idx.shape[0] != q_idx.shape[0]:
        raise ValueError(f"db must be [B, R, Kd], got {tuple(db_idx.shape)}")
    if _build.device_kind(q_idx, "sparse_dot_batched") == "cpu":
        return sparse_dot_plain(q_idx, q_val, db_idx, db_val)
    r = db_idx.shape[1]
    out = _launch(q_idx, q_val, db_idx, db_val, r, r, "sparse_dot_batched")
    sparse_dot_batched.launches += 1
    return out


def sparse_dot(q_idx, q_val, db_idx, db_val) -> torch.Tensor:
    """Shared db (brute force): q [B, Kq] vs db [N, Kd] -> f32 [B, N]."""
    if db_idx.dim() != 2:
        raise ValueError(f"db must be [N, Kd], got {tuple(db_idx.shape)}")
    if _build.device_kind(q_idx, "sparse_dot") == "cpu":
        return sparse_dot_plain(q_idx, q_val, db_idx, db_val)
    out = _launch(q_idx, q_val, db_idx, db_val, db_idx.shape[0], 0,
                  "sparse_dot")
    sparse_dot.launches += 1
    return out


sparse_dot_batched.launches = 0
sparse_dot.launches = 0
