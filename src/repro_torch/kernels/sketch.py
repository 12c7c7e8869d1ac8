"""The index's CountSketch: one CUDA source, one launch per call.

``count_sketch(indices, values, d_proj, seed)`` projects fixed-nnz sparse
rows (``indices`` int64 [B, K] holding uint32 values, ``PAD_INDEX``
padding; ``values`` float32 [B, K]) into a dense float32 [B, d_proj]: each
column adds ``values[b, k] * s`` at coordinate ``h`` of its row, with
``h = uhash(seed, x) % d_proj`` and ``s = +1`` if ``uhash(seed + 1, x)``
is odd, else ``-1``; a ``PAD_INDEX`` column adds 0.0. Each coordinate
sums its terms in column order from +0.0, bitwise the reference's
scatter-add (``repro/ann/sparse.py::count_sketch``).

Replaces no Pallas kernel: the JAX package leaves the sketch to XLA. On
the card the plain version's int64-emulated hashing and its column loop
are 110-140 small launches; ``csrc/sketch.cu`` does the hashing and the
sums in one. The wrapper runs the plain version (the column loop, on the
CPU) for CPU tensors, launches the kernel for CUDA tensors and counts its
launches in ``count_sketch.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import hashing
from repro_torch.core.types import PAD_INDEX
from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 2
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                ctypes.c_uint, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p])


@functools.cache
def max_d_proj() -> int:
    """The widest sketch the kernel takes: its accumulators are d_proj
    floats a warp in shared memory (the repo's sketches are 16-512)."""
    return _build.function("sketch", "sketch_max_d_proj", [])()


@functools.lru_cache(maxsize=64)
def _seed_mixes(seed: int) -> tuple:
    """``fmix32(seed)`` and ``fmix32(seed + 1)``: the two hashes' seeds."""
    return hashing.fmix32(seed), hashing.fmix32(seed + 1)


def count_sketch_plain(indices, values, d_proj: int, seed: int
                       ) -> torch.Tensor:
    """Plain version: the hashing in int64-emulated uint32, then one
    gather, add and write a column. Within one column every row writes
    one coordinate, so no two writes collide, and each coordinate sums its
    terms in column order."""
    h = hashing.uhash(seed, indices) % d_proj
    s = torch.where((hashing.uhash(seed + 1, indices) & 1) == 1, 1.0, -1.0)
    vals = torch.where(indices == PAD_INDEX, 0.0, values * s)
    out = torch.zeros((indices.shape[0], d_proj), dtype=torch.float32,
                      device=values.device)
    rows = torch.arange(indices.shape[0], device=values.device)
    for k in range(indices.shape[1]):
        out[rows, h[:, k]] += vals[:, k]
    return out


def count_sketch(indices, values, d_proj: int, seed: int) -> torch.Tensor:
    """CountSketch of the rows: f32 [B, d_proj] (see the module's note).
    Refuses, on either device, any dtype, rank or pairing but the
    contract's and a d_proj below 1; on the card, a d_proj past
    ``max_d_proj()``."""
    if (indices.dtype != torch.int64 or values.dtype != torch.float32
            or indices.dim() != 2 or indices.shape != values.shape
            or indices.device != values.device):
        raise ValueError(
            f"count_sketch: want indices int64 and values float32 of one "
            f"[B, K] shape on one device; got {indices.dtype} "
            f"{tuple(indices.shape)} on {indices.device} and {values.dtype} "
            f"{tuple(values.shape)} on {values.device}")
    if d_proj < 1:
        raise ValueError(f"count_sketch: d_proj {d_proj} below 1")
    if _build.device_kind(indices, "count_sketch") == "cpu":
        return count_sketch_plain(indices, values, d_proj, seed)
    if d_proj > max_d_proj():
        raise ValueError(f"count_sketch: d_proj {d_proj} past the kernel's "
                         f"{max_d_proj()}")
    b, k = indices.shape
    out = torch.empty((b, d_proj), dtype=torch.float32,
                      device=indices.device)
    if b == 0:
        return out
    _build.check_int32("count_sketch", k=k)
    mix_h, mix_s = _seed_mixes(seed)
    launch = _build.function("sketch", "count_sketch_launch", _ARGTYPES)
    code = launch(indices.data_ptr(), *indices.stride(), values.data_ptr(),
                  *values.stride(), b, k, d_proj, mix_h, mix_s,
                  out.data_ptr(), indices.device.index,
                  _build.stream_of(indices))
    _build.check(code, "sketch", "count_sketch launch")
    count_sketch.launches += 1
    return out


count_sketch.launches = 0
