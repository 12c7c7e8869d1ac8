"""Pair-scorer MLP (F -> H -> H -> 1, tanh, tanh, sigmoid), one CUDA
source with two kernels.

Port of the Pallas kernel ``repro/kernels/scorer_mlp.py::scorer_mlp``
(``scorer_mlp``: features given); the CUDA source is
``csrc/scorer_mlp.cu``. ``pair_score`` is that kernel redesigned with
what precedes it on the serving path: the pair features
(``repro/core/scorer.py::pair_features``) computed from the raw feature
rows, then the MLP, in one launch. Pair p compares candidate row p with
query row ``p // group``, so a query's rows are never repeated.

The wrappers pass the unpadded hidden width: the 128-lane padding of
``repro/kernels/ops.py`` is a TPU matter. CPU tensors run the plain
versions; ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (FIELD_DTYPES, SCALAR,
                                     pair_features_ref, scorer_mlp_ref)

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_PAIR_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p])
# the kernels' limits (hidden width, feature groups), read once
_LIMITS: dict[str, int] = {}


class PairLayout(NamedTuple):
    """The feature groups of a pair, in ``pair_features``' order: their
    kinds (``ref.DENSE``, ``ref.SET``, ``ref.SCALAR``) and widths (D, L,
    1). A group's fields are f32 [rows, D] (dense), i32 [rows, L] (set,
    ``PAD_ITEM`` absent) or f32 [rows] (scalar)."""
    kinds: tuple
    dims: tuple

    @property
    def n_features(self) -> int:
        return sum(1 if k == SCALAR else 2 for k in self.kinds)


def _limit(name: str) -> int:
    if name not in _LIMITS:
        _LIMITS[name] = _build.function("scorer_mlp", name, [])()
    return _LIMITS[name]


def _check_weights(f: int, w0, b0, w1, b1, w2, b2) -> list:
    h = w0.shape[1]
    shapes = {"w0": (w0, (f, h)), "b0": (b0, (h,)), "w1": (w1, (h, h)),
              "b1": (b1, (h,)), "w2": (w2, (h, 1)), "b2": (b2, (1,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return [t for t, _ in shapes.values()]


def _on_card(tensors: list, h: int, dev: torch.device, what: str) -> list:
    """The tensors as contiguous f32 on ``dev``; raises on another dtype
    or device, or a hidden width ``h`` above the kernel's."""
    for t in tensors:
        if t.dtype != torch.float32 or t.device != dev:
            raise TypeError(f"{what} takes float32 tensors on one device")
    if h > _limit("scorer_mlp_max_hidden"):
        raise ValueError(f"hidden width {h} exceeds the kernel's "
                         f"{_limit('scorer_mlp_max_hidden')}")
    return [t.contiguous() for t in tensors]


def scorer_mlp_plain(feats, w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """The plain PyTorch version, same arguments as the kernel."""
    return scorer_mlp_ref(feats, w0, b0, w1, b1, w2, b2)


def scorer_mlp(feats, w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """feats f32 [B, F] + MLP params (w0 [F,H], w1 [H,H], w2 [H,1]) ->
    sigmoid scores f32 [B]."""
    b, f = feats.shape
    weights = _check_weights(f, w0, b0, w1, b1, w2, b2)
    if _build.device_kind(feats, "scorer_mlp") == "cpu":
        return scorer_mlp_plain(feats, *weights)
    dev = feats.device
    args = _on_card([feats] + weights, w0.shape[1], dev, "scorer_mlp")
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    launch = _build.function("scorer_mlp", "scorer_mlp_launch", _ARGTYPES)
    code = launch(*[t.data_ptr() for t in args], out.data_ptr(), b, f,
                  w0.shape[1], dev.index, _build.stream_of(feats))
    _build.check(code, "scorer_mlp", "scorer_mlp launch")
    scorer_mlp.launches += 1
    return out


def pair_score_plain(q_fields, c_fields, layout: PairLayout, group: int,
                     w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """The plain PyTorch version, same arguments as the kernel: the pair
    features of the query rows repeated ``group`` times, then the MLP."""
    q = [t.repeat_interleave(group, dim=0) for t in q_fields]
    return scorer_mlp_ref(pair_features_ref(q, c_fields, layout.kinds),
                          w0, b0, w1, b1, w2, b2)


def _check_fields(q_fields, c_fields, layout: PairLayout,
                  group: int) -> tuple[int, int]:
    """Raise unless the fields match the layout and P = Q * group;
    returns (Q, P)."""
    n = len(layout.kinds)
    if len(layout.dims) != n or len(q_fields) != n or len(c_fields) != n:
        raise ValueError(f"pair_score: {n} groups in the layout, "
                         f"{len(q_fields)} query and {len(c_fields)} "
                         f"candidate fields")
    if n == 0 or group < 1:
        raise ValueError(f"pair_score: needs a group and group >= 1, got "
                         f"{n} groups, group {group}")
    nq, nc = q_fields[0].shape[0], c_fields[0].shape[0]
    if nc != nq * group:
        raise ValueError(f"pair_score: {nc} candidate rows for {nq} query "
                         f"rows of group {group}")
    for q, c, kind, dim in zip(q_fields, c_fields, layout.kinds,
                               layout.dims):
        want = (dim,) if kind != SCALAR else ()
        if (tuple(q.shape) != (nq, *want) or tuple(c.shape) != (nc, *want)
                or q.dtype != FIELD_DTYPES[kind] or c.dtype != q.dtype):
            raise ValueError(
                f"pair_score: a group of kind {kind} and width {dim} got "
                f"{q.dtype} {tuple(q.shape)} and {c.dtype} {tuple(c.shape)}")
    return nq, nc


def pair_score(q_fields, c_fields, layout: PairLayout, group: int,
               w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """Edge weights f32 [P] of P = Q * group pairs: pair p is candidate
    row p of ``c_fields`` against query row ``p // group`` of
    ``q_fields`` (one tensor per group of ``layout``), scored by the MLP
    (w0 [F, H] ... b2 [1], F = layout.n_features)."""
    _, p = _check_fields(q_fields, c_fields, layout, group)
    weights = _check_weights(layout.n_features, w0, b0, w1, b1, w2, b2)
    dev = w0.device
    if any(t.device != dev for t in (*q_fields, *c_fields)):
        raise ValueError(f"pair_score: fields and weights on more than one "
                         f"device ({dev})")
    if _build.device_kind(w0, "pair_score") == "cpu":
        return pair_score_plain(q_fields, c_fields, layout, group, *weights)
    if len(layout.kinds) > _limit("pair_score_max_groups"):
        raise ValueError(f"pair_score: {len(layout.kinds)} feature groups; "
                         f"the kernel takes {_limit('pair_score_max_groups')}")
    weights = _on_card(weights, w0.shape[1], dev, "pair_score")
    q = [t.contiguous() for t in q_fields]
    c = [t.contiguous() for t in c_fields]
    n = len(layout.kinds)
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    launch = _build.function("scorer_mlp", "pair_score_launch",
                             _PAIR_ARGTYPES)
    code = launch((ctypes.c_void_p * n)(*[t.data_ptr() for t in q]),
                  (ctypes.c_void_p * n)(*[t.data_ptr() for t in c]),
                  (ctypes.c_int * n)(*layout.kinds),
                  (ctypes.c_int * n)(*layout.dims), n,
                  *[t.data_ptr() for t in weights], out.data_ptr(), p, group,
                  layout.n_features, w0.shape[1], dev.index,
                  _build.stream_of(w0))
    _build.check(code, "scorer_mlp", "pair_score launch")
    pair_score.launches += 1
    return out


scorer_mlp.launches = 0
pair_score.launches = 0
