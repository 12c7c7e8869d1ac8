"""Vectorized 32-bit integer hashing (port of ``repro/core/hashing.py``).

The reference mixes ``uint32`` lanes. torch has no ``>>`` or ``+`` on
uint32, so every value here is a uint32 held in int64 (or a Python int):
each add and multiply is reduced with ``& 0xFFFFFFFF``. Products are
split into 16-bit halves so no int64 product can overflow, which keeps the
low 32 bits exact on every device. Results are bitwise those of the
reference.

Who runs it: on the CPU the plain versions of the bucket columns
(``kernels/buckets.py``, called by ``core/buckets.py``) and of the
CountSketch (``kernels/sketch.py``, called by ``ann/sparse.py``); on the
card those come from the CUDA kernels of ``kernels/csrc/buckets.cu`` and
``kernels/csrc/sketch.cu``, which compute the same functions in native
uint32 (``csrc/hash.cuh``). The sharded backend's routing still calls
these functions on every device.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _u32(x):
    """uint32 view of an int tensor or Python int (negatives wrap)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x < 2^32, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(x):
    """murmur3 finalizer: a full-avalanche 32-bit mix."""
    x = _u32(x)
    x ^= x >> 16
    x = _mul32(x, 0x85EBCA6B)
    x ^= x >> 13
    x = _mul32(x, 0xC2B2AE35)
    x ^= x >> 16
    return x


def combine(h, v):
    """Order-sensitive hash combine (boost-style, then re-mixed)."""
    h = _u32(h)
    v = _u32(v)
    return fmix32(h ^ ((v + _GOLDEN + ((h << 6) & M32) + (h >> 2)) & M32))


def hash_fields(*fields):
    """Hash a sequence of uint32-castable fields into one bucket ID."""
    h = 0x811C9DC5
    for f in fields:
        h = combine(h, f)
    return h


def uhash(seed: int, x):
    """Seeded universal-style hash of int arrays -> uint32 (in int64)."""
    return fmix32(_mul32(_u32(x), _GOLDEN) ^ fmix32(seed))
