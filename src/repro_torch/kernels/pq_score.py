"""PQ lookup-table scoring: one CUDA kernel for two TPU kernels.

Port of the Pallas kernels ``repro/kernels/pq_score.py::pq_score_batched``
(codes per query: the ``fused=False`` shortlist) and ``::pq_score`` (codes
shared by every query). The CUDA source is ``csrc/pq_score.cu``; it takes
the shared form as a codes batch stride of 0 and notes its design and
bound.

Result contract (bitwise, kernel == plain version): each score is the
sum of the candidate's table entries over the subspaces in order, left to
right, in float32 (``ref.pq_score_seq_ref``). Each wrapper runs its plain
version for CPU tensors and counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pq_score_seq_ref

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_longlong, ctypes.c_void_p])


def pq_score_plain(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain version of both forms: codes [B, N, M] or shared [N, M]."""
    if codes.dim() == 2:
        codes = codes.expand(lut.shape[0], *codes.shape)
    return pq_score_seq_ref(lut, codes)


def _on_card(lut, codes, what: str) -> bool:
    """Check the arguments; True for CUDA tensors, False for CPU ones."""
    if lut.dtype != torch.float32 or codes.dtype != torch.uint8:
        raise TypeError(f"{what}: lut must be f32 and codes u8, got "
                        f"{lut.dtype} and {codes.dtype}")
    if lut.dim() != 3 or codes.shape[-1] != lut.shape[1]:
        raise ValueError(f"{what}: codes {tuple(codes.shape)} do not match "
                         f"lut {tuple(lut.shape)}")
    if codes.device != lut.device:
        raise ValueError(f"{what}: codes on {codes.device}, lut on "
                         f"{lut.device}")
    return _build.device_kind(lut, what) == "cuda"


def _launch(lut, codes, n: int, batch_rows: int, what: str) -> torch.Tensor:
    b, m, c = lut.shape
    lut, codes = lut.contiguous(), codes.contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=lut.device)
    launch = _build.function("pq_score", "pq_score_launch", _ARGTYPES)
    with torch.cuda.device(lut.device):
        code = launch(_build.ptr(lut), _build.ptr(codes), _build.ptr(out),
                      b, n, m, c, batch_rows, _build.stream_of(lut))
    _build.check(code, "pq_score", f"{what} launch")
    return out


def pq_score_batched(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Per-query slabs: lut f32 [B, M, C]; codes u8 [B, N, M] -> f32 [B, N]."""
    if codes.dim() != 3 or codes.shape[0] != lut.shape[0]:
        raise ValueError(f"codes must be [B, N, M], got {tuple(codes.shape)}")
    if not _on_card(lut, codes, "pq_score_batched"):
        return pq_score_plain(lut, codes)
    out = _launch(lut, codes, codes.shape[1], codes.shape[1],
                  "pq_score_batched")
    pq_score_batched.launches += 1
    return out


def pq_score(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Shared codes: lut f32 [B, M, C]; codes u8 [N, M] -> f32 [B, N]."""
    if codes.dim() != 2:
        raise ValueError(f"codes must be [N, M], got {tuple(codes.shape)}")
    if not _on_card(lut, codes, "pq_score"):
        return pq_score_plain(lut, codes)
    out = _launch(lut, codes, codes.shape[0], 0, "pq_score")
    pq_score.launches += 1
    return out


pq_score_batched.launches = 0
pq_score.launches = 0
