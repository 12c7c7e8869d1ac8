"""Row-wise top-k selection with the lowest index winning ties, one CUDA
kernel.

Port of the Pallas kernel ``repro/kernels/topk_select.py::topk_select``;
the CUDA source is ``csrc/topk_select.cu``, which notes its design and
what bounds it on the H100. Values come in descending order, equal values
(-inf included) by ascending index. Two orders differ only at signed
zeros, and the reference has both:

* the Pallas kernel's (``signed_zeros=False``; the reference's
  ``ops.topk_select`` at k <= 64): -0.0 and +0.0 tie, the lowest index
  wins, and each round writes the maximum of the entries still alive, so
  a -0.0 winner is written as +0.0 while a +0.0 is still alive;
* ``lax.top_k``'s (``signed_zeros=True``; above k = 64): +0.0 ranks above
  -0.0, then the lowest index, each entry with its own value
  (``ref.topk_ref``).

``topk_select`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; ``topk_select.launches`` counts the calls that
launched it (a long row's call is two or more launches: a split and its
merges).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import topk_ref

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6
             + [ctypes.c_void_p])
CHUNK = 4096      # entries a block selects from on a long row (one index slab)


def chunk_plan(n: int, k: int) -> tuple[int, int]:
    """How the kernels split a row of ``n`` entries for a top-``k``:
    (chunk length, int64 scratch words per row). A row longer than one
    chunk is cut into chunks whose top-min(k, chunk) a block each selects
    (the chunk doubles for k above ``CHUNK // 2``). While 2k <= chunk,
    levels of chunks over the survivors shrink the row until one block
    holds it; above, the chunks' sorted runs are merged pairwise in device
    memory, each merge keeping the top min(k, both runs), until one run is
    left (``csrc/select.cuh``), so every k <= n is taken. Scratch: two
    ping-pong buffers of the first split's survivors and one word per
    chunk."""
    s = CHUNK if n <= CHUNK or 2 * k <= CHUNK else 2 * CHUNK
    chunks = -(-n // s)
    if chunks == 1:
        return s, 0
    return s, 2 * chunks * min(k, s) + chunks


def topk_select_plain(scores: torch.Tensor, k: int, *,
                      signed_zeros: bool = False):
    """The plain PyTorch version: (values f32 [B, k], indices i32 [B, k])
    in the order ``signed_zeros`` names (module docstring)."""
    if signed_zeros:
        vals, idxs = topk_ref(scores, k)
        return vals, idxs.to(torch.int32)
    # a stable sort on the floats ties -0.0 with +0.0
    vals, idxs = torch.sort(scores, dim=-1, descending=True, stable=True)
    # round r writes the maximum of the entries still alive (sorted
    # positions >= r): +0.0 for a zero while a +0.0 is left at or after r
    pos_zero = (vals == 0) & ~torch.signbit(vals)
    left = pos_zero.flip(-1).to(torch.int32).cumsum(-1).flip(-1) > 0
    vals = torch.where((vals == 0) & left, 0.0, vals)
    return vals[..., :k], idxs[..., :k].to(torch.int32)


def topk_select(scores: torch.Tensor, k: int, *, signed_zeros: bool = False):
    """scores f32 [B, N] -> (values f32 [B, k], indices i32 [B, k])."""
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise TypeError(f"scores must be f32 [B, N], got {scores.dtype} "
                        f"{tuple(scores.shape)}")
    b, n = scores.shape
    if not 0 < k <= n:
        raise ValueError(f"k={k} must be in 1..{n} (row length)")
    if _build.device_kind(scores, "topk_select") == "cpu":
        return topk_select_plain(scores, k, signed_zeros=signed_zeros)
    chunk, words = chunk_plan(n, k)
    scores = scores.contiguous()
    dev = scores.device
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((b, k), dtype=torch.int32, device=dev)
    scratch = (torch.empty(b * words, dtype=torch.int64, device=dev)
               if words else None)
    launch = _build.function("topk_select", "topk_select_launch", _ARGTYPES)
    code = launch(scores.data_ptr(), vals.data_ptr(), idxs.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), b * words,
                  b, n, k, chunk, int(signed_zeros), dev.index,
                  _build.stream_of(scores))
    _build.check(code, "topk_select", "topk_select launch")
    topk_select.launches += 1
    return vals, idxs


topk_select.launches = 0
