"""Published peaks of the chips the benchmark runs on, and the least time
a kernel's work can take on them.

NVIDIA H100 SXM data sheet, dense rates: 3.35 TB/s of HBM3, 67 TFLOP/s
in float32 outside the tensor cores. The rates hold at the card's full
power limit (700 W).
"""
from __future__ import annotations

PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "f32_ops_per_s": 67e12}}
DEFAULT = "NVIDIA H100 80GB HBM3"


def peak(kind: str | None) -> dict:
    return PEAKS.get(kind or DEFAULT, PEAKS[DEFAULT])


def bound_s(n_bytes: float, n_ops: float, kind: str | None = None) -> float:
    """max(bytes / bandwidth, operations / f32 rate): each input byte read
    once, each output byte written once."""
    p = peak(kind)
    return max(n_bytes / p["bytes_per_s"], n_ops / p["f32_ops_per_s"])


def fused_query_work(b: int, n: int, m: int, c: int, k: int) -> tuple:
    """Bytes and operations of one fused PQ shortlist call (lut f32
    [B, M, C]; per candidate M code bytes, an int32 id, a bool valid and
    an f32 bias; out f32 + int32 per selected entry; M table adds and the
    bias add per candidate, one comparison each)."""
    n_bytes = b * m * c * 4 + b * n * (m + 4 + 1 + 4) + b * k * 8
    n_ops = b * n * (m + 1) + b * n
    return n_bytes, n_ops
