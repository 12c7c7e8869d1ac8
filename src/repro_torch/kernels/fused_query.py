"""Fused query shortlist: PQ-score -> top-k -> SOAR dedup, one CUDA kernel.

Port of the Pallas kernel ``repro/kernels/fused_query.py::
fused_query_kernel``; the CUDA source is ``csrc/fused_query.cu``, which
notes its design and what bounds it on the H100.

Result contract (bitwise, kernel == plain version == reference):

* ``idxs`` are the top-k positions of ``where(valid, pq + bias, -inf)``
  with ties resolved to the lowest candidate index (fully-invalid rows
  yield ``0 .. k-1``); ``pq`` sums the LUT entries over the subspaces in
  order, left to right, in float32;
* ``vals[i]`` is that score, unless an earlier shortlist entry carries the
  same point id with both entries valid: then ``-inf`` (dedup-after-cut).

``fused_query_kernel`` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; ``fused_query_kernel.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (pq_score_seq_ref, shortlist_dedup_ref,
                                     topk_ref)

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def fused_query_plain(lut, codes, ids, valid, bias, k: int):
    """The plain PyTorch version, same arguments as the kernel."""
    scores = torch.where(valid, pq_score_seq_ref(lut, codes) + bias,
                         float("-inf"))
    vals, idxs = topk_ref(scores, k)
    return shortlist_dedup_ref(vals, idxs, ids, valid), idxs.to(torch.int32)


def _check_args(lut, codes, ids, valid, bias, k):
    b, m, c = lut.shape
    if codes.shape[0] != b or codes.shape[2] != m:
        raise ValueError(f"codes {tuple(codes.shape)} do not match lut "
                         f"{tuple(lut.shape)}")
    n = codes.shape[1]
    if not 0 < k <= n:
        raise ValueError(f"k={k} must be in 1..{n} (candidate count)")
    want = {"lut": (lut, torch.float32), "codes": (codes, torch.uint8),
            "ids": (ids, torch.int32), "valid": (valid, torch.bool),
            "bias": (bias, torch.float32)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != lut.device:
            raise ValueError(f"{name} is on {t.device}, lut on {lut.device}")
    for name, t in (("ids", ids), ("valid", valid), ("bias", bias)):
        if tuple(t.shape) != (b, n):
            raise ValueError(f"{name} must be [{b}, {n}], got "
                             f"{tuple(t.shape)}")
    return b, n, m, c


def fused_query_kernel(lut, codes, ids, valid, bias, k: int):
    """lut f32 [B,M,C]; codes u8 [B,N,M]; ids i32 [B,N]; valid bool [B,N];
    bias f32 [B,N] -> (vals f32 [B,k], idxs i32 [B,k])."""
    b, n, m, c = _check_args(lut, codes, ids, valid, bias, k)
    if lut.device.type == "cpu":
        return fused_query_plain(lut, codes, ids, valid, bias, k)
    if lut.device.type != "cuda":
        raise ValueError(f"no fused_query kernel for device {lut.device}")
    args = [t.contiguous() for t in (lut, codes, ids, valid, bias)]
    vals = torch.empty((b, k), dtype=torch.float32, device=lut.device)
    idxs = torch.empty((b, k), dtype=torch.int32, device=lut.device)
    needs = _build.function("fused_query", "fused_query_needs_scratch",
                            [ctypes.c_int] * 4)
    scores = alive = None
    if needs(n, m, c, k):
        scores = torch.empty((b, n), dtype=torch.float32, device=lut.device)
        alive = torch.empty((b, (n + 31) // 32), dtype=torch.int32,
                            device=lut.device)
    launch = _build.function("fused_query", "fused_query_launch", _ARGTYPES)
    with torch.cuda.device(lut.device):
        code = launch(*map(_build.ptr, args), _build.ptr(vals),
                      _build.ptr(idxs), _build.ptr(scores), _build.ptr(alive),
                      b, n, m, c, k, _build.stream_of(lut))
    _build.check(code, "fused_query", "fused_query_kernel launch")
    fused_query_kernel.launches += 1
    return vals, idxs


fused_query_kernel.launches = 0
