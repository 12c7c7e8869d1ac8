"""LSH bucket-ID columns: one CUDA source, two launches per call.

The column arithmetic of ``core/buckets.py::generate_buckets``, everything
after the SimHash projection: each SimHash table's sign bits packed into a
code, each MinHash table's minimum over a row's items, each scalar's bin,
every one hashed with ``hashing.hash_fields`` into the bucket id at its
column of ``ids`` int64 [B, k_max] (uint32 values) and ``valid`` bool
[B, k_max]. Columns lie in ``generate_buckets``' order: dense modes
(sorted by name) x ``dense_tables``, then set modes x ``set_tables``, then
scalar modes x ``len(scalar_widths)``.

Replaces no Pallas kernel: the JAX package leaves these columns to XLA's
uint32 ops. On the card the plain version's int64 emulation of uint32 is
a chain of small elementwise kernels for every column; the CUDA source
(``csrc/buckets.cu``) computes all dense and scalar columns in one launch
(``simhash_scalar_columns``) and all set tables in another
(``minhash_columns``), whatever the number of modes. Its per-column
constants (``column_constants``) come from the schema and the
``BucketConfig`` alone and are cached on the device; nothing is drawn
from the hyperplanes' generator.

Result contract (bitwise, kernel == plain version): the same ids and
valid flags from the same projections, items and scalars. Each wrapper
runs its plain version (the column loop, on the CPU) for CPU tensors,
launches the kernel for CUDA tensors and counts its launches in
``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import zlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.types import PAD_ITEM
from repro_torch.kernels import _build

_SIMHASH_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                ctypes.c_int]
                     + [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                ctypes.c_void_p])
_MINHASH_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                ctypes.c_int]
                     + [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                ctypes.c_void_p])


def mode_tag(kind: str, name: str) -> int:
    """The hash tag of one mode's columns."""
    return zlib.crc32(f"{kind}:{name}".encode())


class Columns(NamedTuple):
    """Per-column constants as Python ints: ``prefix[c]`` is column c's
    ``hash_fields`` state before its value (the tag and the table or
    width index combined in), ``seed_mix[t]`` MinHash table t's
    ``fmix32(seed * 131 + t)``."""
    prefix: list
    seed_mix: list


def column_constants(spec, cfg) -> Columns:
    """The kernels' constants for a schema and a ``BucketConfig``."""
    prefix = []
    for kind, names, per_mode in (("dense", spec.dense, cfg.dense_tables),
                                  ("set", spec.sets, cfg.set_tables),
                                  ("scalar", spec.scalars,
                                   len(cfg.scalar_widths))):
        for name in sorted(names):
            tag = mode_tag(kind, name)
            prefix += [hashing.hash_fields(tag, t) for t in range(per_mode)]
    return Columns(prefix, [hashing.fmix32(cfg.seed * 131 + t)
                            for t in range(cfg.set_tables)])


@functools.lru_cache(maxsize=64)
def _device_constants(spec, cfg, device: torch.device) -> tuple:
    """(prefix, seed_mix) as int32 bit patterns of the uint32 values and
    the scalar widths as float32, on ``device``."""
    cols = column_constants(spec, cfg)

    def bits(values):
        return torch.as_tensor(np.asarray(values, np.uint32).view(np.int32)
                               ).to(device)
    return (bits(cols.prefix), bits(cols.seed_mix),
            torch.tensor(cfg.scalar_widths, dtype=torch.float32,
                         device=device))


@functools.cache
def _max_modes() -> int:
    return _build.function("buckets", "buckets_max_modes", [])()


def _check_out(ids, valid, spec, cfg, what: str) -> bool:
    """Raise unless ``ids`` / ``valid`` are the [B, k_max] outputs on one
    device; True for CUDA tensors, False for CPU ones."""
    shape = (ids.shape[0], cfg.k_max(spec))
    if (ids.dtype != torch.int64 or valid.dtype != torch.bool
            or tuple(ids.shape) != shape or tuple(valid.shape) != shape
            or valid.device != ids.device):
        raise ValueError(f"{what}: ids must be int64 and valid bool, both "
                         f"{shape} on one device; got {ids.dtype} "
                         f"{tuple(ids.shape)} and {valid.dtype} "
                         f"{tuple(valid.shape)}")
    return _build.device_kind(ids, what) == "cuda"


def _check_inputs(arrays, dtype, shapes, dev, what: str) -> None:
    """Raise unless each array has ``dtype``, its shape and ``dev``, and
    the kernel takes that many modes."""
    if len(arrays) > _max_modes():
        raise ValueError(f"{what}: {len(arrays)} modes of one kind; the "
                         f"kernel takes {_max_modes()}")
    for t, shape in zip(arrays, shapes):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{what}: want {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _modes(arrays, widths=None) -> tuple:
    """The ctypes arrays of a kind's pointers, strides (three a mode,
    padded with 0) and widths; the tensors must outlive the launch."""
    n = len(arrays)
    strides = [s for t in arrays for s in (list(t.stride()) + [0, 0])[:3]]
    return ((ctypes.c_void_p * n)(*[t.data_ptr() for t in arrays]),
            (ctypes.c_longlong * (3 * n))(*strides),
            (ctypes.c_int * n)(*(widths or [0] * n)))


def simhash_scalar_columns_plain(projections, scalars, spec, cfg, ids,
                                 valid) -> None:
    """Plain version: the column loop in int64-emulated uint32."""
    tables = cfg.dense_tables
    col = 0
    for name, proj in zip(sorted(spec.dense), projections):
        bits = (proj > 0).to(torch.int64)
        weights = torch.ones((), dtype=torch.int64, device=proj.device) \
            << torch.arange(cfg.dense_bits, device=proj.device)
        codes = (bits * weights).sum(-1)                 # [T, B]
        tag = mode_tag("dense", name)
        for t in range(tables):
            ids[:, col] = hashing.hash_fields(tag, t, codes[t])
            valid[:, col] = True
            col += 1
    col += len(spec.sets) * cfg.set_tables
    for name, x in zip(sorted(spec.scalars), scalars):
        tag = mode_tag("scalar", name)
        for wi, width in enumerate(cfg.scalar_widths):
            bin_id = torch.floor(x / width).to(torch.int32)
            ids[:, col] = hashing.hash_fields(tag, wi, bin_id)
            valid[:, col] = True
            col += 1


def simhash_scalar_columns(projections, scalars, spec, cfg, ids,
                           valid) -> None:
    """Every SimHash and scalar column into ``ids`` / ``valid``:
    ``projections`` f32 [dense_tables, B, dense_bits] per dense mode and
    ``scalars`` f32 [B] per scalar mode, each in sorted mode order."""
    if not _check_out(ids, valid, spec, cfg, "simhash_scalar_columns"):
        return simhash_scalar_columns_plain(projections, scalars, spec, cfg,
                                            ids, valid)
    b, dev = ids.shape[0], ids.device
    _check_inputs(projections, torch.float32,
                  [(cfg.dense_tables, b, cfg.dense_bits)] * len(spec.dense),
                  dev, "simhash_scalar_columns")
    _check_inputs(scalars, torch.float32, [(b,)] * len(spec.scalars), dev,
                  "simhash_scalar_columns")
    if not ids.is_contiguous() or not valid.is_contiguous():
        raise ValueError("simhash_scalar_columns: ids and valid must be "
                         "contiguous")
    if b == 0 or not (projections or scalars):
        return
    prefix, _, width = _device_constants(spec, cfg, dev)
    launch = _build.function("buckets", "simhash_scalar_launch",
                             _SIMHASH_ARGTYPES)
    d_ptrs, d_strides, _ = _modes(projections)
    s_ptrs, s_strides, _ = _modes(scalars)
    code = launch(d_ptrs, d_strides, len(projections), cfg.dense_tables,
                  cfg.dense_bits, s_ptrs, s_strides, len(scalars),
                  len(cfg.scalar_widths),
                  len(spec.dense) * cfg.dense_tables
                  + len(spec.sets) * cfg.set_tables,
                  prefix.data_ptr(), width.data_ptr(), b, ids.shape[1],
                  ids.data_ptr(), valid.data_ptr(), dev.index,
                  _build.stream_of(ids))
    _build.check(code, "buckets", "simhash_scalar_columns launch")
    simhash_scalar_columns.launches += 1


def minhash_columns_plain(sets, spec, cfg, ids, valid) -> None:
    """Plain version: the MinHash table loop in int64-emulated uint32."""
    col = len(spec.dense) * cfg.dense_tables
    for name, items in zip(sorted(spec.sets), sets):
        present = items != PAD_ITEM
        any_item = present.any(-1)
        tag = mode_tag("set", name)
        for t in range(cfg.set_tables):
            hashed = hashing.uhash(cfg.seed * 131 + t, items)
            hashed = torch.where(present, hashed, hashing.M32)
            minh = hashed.amin(-1)                       # [B]
            ids[:, col] = hashing.hash_fields(tag, t, minh)
            valid[:, col] = any_item
            col += 1


def minhash_columns(sets, spec, cfg, ids, valid) -> None:
    """Every MinHash column into ``ids`` / ``valid``: ``sets`` i32
    [B, cap] per set mode (``PAD_ITEM`` absent), in sorted mode order."""
    if not _check_out(ids, valid, spec, cfg, "minhash_columns"):
        return minhash_columns_plain(sets, spec, cfg, ids, valid)
    b, dev = ids.shape[0], ids.device
    names = sorted(spec.sets)
    _check_inputs(sets, torch.int32, [(b, spec.sets[n]) for n in names], dev,
                  "minhash_columns")
    if not ids.is_contiguous() or not valid.is_contiguous():
        raise ValueError("minhash_columns: ids and valid must be contiguous")
    if b == 0 or not sets:
        return
    prefix, seed_mix, _ = _device_constants(spec, cfg, dev)
    launch = _build.function("buckets", "minhash_launch", _MINHASH_ARGTYPES)
    ptrs, strides, caps = _modes(sets, [spec.sets[n] for n in names])
    code = launch(ptrs, strides, caps, len(sets), cfg.set_tables,
                  len(spec.dense) * cfg.dense_tables, prefix.data_ptr(),
                  seed_mix.data_ptr(), b, ids.shape[1], ids.data_ptr(),
                  valid.data_ptr(), dev.index, _build.stream_of(ids))
    _build.check(code, "buckets", "minhash_columns launch")
    minhash_columns.launches += 1


simhash_scalar_columns.launches = 0
minhash_columns.launches = 0
