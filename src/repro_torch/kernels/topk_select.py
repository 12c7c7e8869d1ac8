"""Row-wise top-k selection with the lowest index winning ties, one CUDA
kernel.

Port of the Pallas kernel ``repro/kernels/topk_select.py::topk_select``;
the CUDA source is ``csrc/topk_select.cu``, which notes its design and
what bounds it on the H100. The result is ``lax.top_k``'s: values in
descending order, equal values (-inf included) by ascending index, so the
plain version is the stable descending sort of ``ref.topk_ref``.

``topk_select`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; ``topk_select.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import topk_ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def topk_select_plain(scores: torch.Tensor, k: int):
    """The plain PyTorch version: (values f32 [B, k], indices i32 [B, k])."""
    vals, idxs = topk_ref(scores, k)
    return vals, idxs.to(torch.int32)


def topk_select(scores: torch.Tensor, k: int):
    """scores f32 [B, N] -> (values f32 [B, k], indices i32 [B, k])."""
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise TypeError(f"scores must be f32 [B, N], got {scores.dtype} "
                        f"{tuple(scores.shape)}")
    b, n = scores.shape
    if not 0 < k <= n:
        raise ValueError(f"k={k} must be in 1..{n} (row length)")
    if _build.device_kind(scores, "topk_select") == "cpu":
        return topk_select_plain(scores, k)
    scores = scores.contiguous()
    vals = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    idxs = torch.empty((b, k), dtype=torch.int32, device=scores.device)
    needs = _build.function("topk_select", "topk_select_needs_scratch",
                            [ctypes.c_int])
    alive = None
    if needs(n):
        alive = torch.empty((b, (n + 31) // 32), dtype=torch.int32,
                            device=scores.device)
    launch = _build.function("topk_select", "topk_select_launch", _ARGTYPES)
    with torch.cuda.device(scores.device):
        code = launch(_build.ptr(scores), _build.ptr(vals), _build.ptr(idxs),
                      _build.ptr(alive), b, n, k,
                      _build.stream_of(scores))
    _build.check(code, "topk_select", "topk_select launch")
    topk_select.launches += 1
    return vals, idxs


topk_select.launches = 0
