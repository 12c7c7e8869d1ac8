"""Fused query shortlist: PQ-score -> top-k -> SOAR dedup, one CUDA kernel
in two instances (f32 table and int8 table).

Port of the Pallas kernels ``repro/kernels/fused_query.py::
fused_query_kernel`` and ``::fused_query_kernel_int8``; the CUDA source is
``csrc/fused_query.cu``, which notes its design and what bounds it on the
H100.

Result contract (bitwise, kernel == plain version == reference):

* ``idxs`` are the top-k positions of ``where(valid, pq + bias, -inf)``
  with ties resolved to the lowest candidate index (fully-invalid rows
  yield ``0 .. k-1``); ``pq`` sums the LUT entries over the subspaces in
  order, left to right, in float32;
* ``vals[i]`` is that score, unless an earlier shortlist entry carries the
  same point id with both entries valid: then ``-inf`` (dedup-after-cut).

The int8 variant scores from a symmetric int8 table per (query,
subspace) (``quantize_lut``), dequantised before the ordered sum:
``lut = qlut * scale``, one rounded product per table entry, so the scale
multiply never sits in the accumulation chain. It is bitwise with its own
plain version; quantisation moves its scores away from the f32 path by
construction.

Each wrapper launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; ``<wrapper>.launches`` counts the calls that
launched it (a call is two kernel launches, the chunks then the merge,
or more on long rows: ``csrc/fused_query.cu``). Every k <= N takes the
kernel: while 2k <= the chunk (``topk_select.chunk_plan``: k <= 2,048 on
rows of more than 8,192 candidates, k <= 4,096 below) one merge block
per row merges the chunks and dedups; above that the chunks' sorted runs
are merged pairwise in device memory and a dedup kernel follows.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import topk_select as _tk
from repro_torch.kernels.ref import (pq_score_seq_ref, shortlist_dedup_ref,
                                     topk_ref)

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 7
             + [ctypes.c_void_p])
_ARGTYPES_INT8 = [ctypes.c_void_p] + _ARGTYPES
_INV_127 = float(np.float32(1.0 / 127.0))


def quantize_lut(lut: torch.Tensor):
    """Symmetric per-(query, subspace) int8 quantisation of an f32 table:
    lut f32 [B, M, C] -> (qlut i8 [B, M, C], scale f32 [B, M]).
    ``torch.round`` rounds half to even, as ``jnp.round`` does. XLA
    compiles the reference's ``amax / 127.0`` into a product with the f32
    reciprocal of 127, so the scale is that product here too."""
    amax = lut.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax * _INV_127, 1.0)
    qlut = torch.round(lut / scale[..., None]).to(torch.int8)
    return qlut, scale


def dequantize_lut(qlut: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The f32 table the int8 path scores from: one product per entry."""
    return qlut.to(torch.float32) * scale[..., None]


def fused_query_plain(lut, codes, ids, valid, bias, k: int):
    """The plain PyTorch version, same arguments as the kernel."""
    scores = torch.where(valid, pq_score_seq_ref(lut, codes) + bias,
                         float("-inf"))
    vals, idxs = topk_ref(scores, k)
    return shortlist_dedup_ref(vals, idxs, ids, valid), idxs.to(torch.int32)


def fused_query_int8_plain(qlut, scale, codes, ids, valid, bias, k: int):
    """The plain version of the int8 kernel, same arguments."""
    return fused_query_plain(dequantize_lut(qlut, scale), codes, ids, valid,
                             bias, k)


def _check_args(lut, codes, ids, valid, bias, k, lut_dtype=torch.float32):
    b, m, c = lut.shape
    if codes.shape[0] != b or codes.shape[2] != m:
        raise ValueError(f"codes {tuple(codes.shape)} do not match lut "
                         f"{tuple(lut.shape)}")
    n = codes.shape[1]
    if not 0 < k <= n:
        raise ValueError(f"k={k} must be in 1..{n} (candidate count)")
    want = {"lut": (lut, lut_dtype), "codes": (codes, torch.uint8),
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


def _launch(entry: str, table, codes, ids, valid, bias, k: int):
    """Launch one instance; ``table`` is (lut,) or (qlut, scale)."""
    lut = table[0]
    b, m, c = lut.shape
    n = codes.shape[1]
    chunk, words = _tk.chunk_plan(n, k)
    _build.check_int32("fused_query", N=n, blocks=b * -(-n // chunk))
    args = [t.contiguous() for t in (*table, codes, ids, valid, bias)]
    dev = lut.device
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((b, k), dtype=torch.int32, device=dev)
    scratch = (torch.empty(b * words, dtype=torch.int64, device=dev)
               if words else None)
    argtypes = _ARGTYPES_INT8 if len(table) == 2 else _ARGTYPES
    launch = _build.function("fused_query", entry, argtypes)
    code = launch(*[t.data_ptr() for t in args], vals.data_ptr(),
                  idxs.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), b * words,
                  b, n, m, c, k, chunk, dev.index, _build.stream_of(lut))
    _build.check(code, "fused_query", entry)
    return vals, idxs


def fused_query_kernel(lut, codes, ids, valid, bias, k: int):
    """lut f32 [B,M,C]; codes u8 [B,N,M]; ids i32 [B,N]; valid bool [B,N];
    bias f32 [B,N] -> (vals f32 [B,k], idxs i32 [B,k])."""
    _check_args(lut, codes, ids, valid, bias, k)
    if _build.device_kind(lut, "fused_query") == "cpu":
        return fused_query_plain(lut, codes, ids, valid, bias, k)
    out = _launch("fused_query_launch", (lut,), codes, ids, valid, bias, k)
    fused_query_kernel.launches += 1
    return out


def fused_query_kernel_int8(qlut, scale, codes, ids, valid, bias, k: int):
    """qlut i8 [B,M,C]; scale f32 [B,M]; the rest as ``fused_query_kernel``
    -> (vals f32 [B,k], idxs i32 [B,k])."""
    b, _, m, _ = _check_args(qlut, codes, ids, valid, bias, k, torch.int8)
    if scale.dtype != torch.float32 or tuple(scale.shape) != (b, m) \
            or scale.device != qlut.device:
        raise ValueError(f"scale must be f32 [{b}, {m}] on {qlut.device}, "
                         f"got {scale.dtype} {tuple(scale.shape)} on "
                         f"{scale.device}")
    if _build.device_kind(qlut, "fused_query_int8") == "cpu":
        return fused_query_int8_plain(qlut, scale, codes, ids, valid, bias, k)
    out = _launch("fused_query_int8_launch", (qlut, scale), codes, ids, valid,
                  bias, k)
    fused_query_kernel_int8.launches += 1
    return out


fused_query_kernel.launches = 0
fused_query_kernel_int8.launches = 0
