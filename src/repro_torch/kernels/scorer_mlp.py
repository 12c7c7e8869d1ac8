"""Fused pair-scorer MLP (F -> H -> H -> 1, tanh, tanh, sigmoid).

Port of the Pallas kernel ``repro/kernels/scorer_mlp.py::scorer_mlp``;
the CUDA source is ``csrc/scorer_mlp.cu``. The wrapper passes the
unpadded hidden width: the 128-lane padding of ``repro/kernels/ops.py`` is
a TPU matter. CPU tensors run the plain version; ``scorer_mlp.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import scorer_mlp_ref

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def scorer_mlp_plain(feats, w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """The plain PyTorch version, same arguments as the kernel."""
    return scorer_mlp_ref(feats, w0, b0, w1, b1, w2, b2)


def scorer_mlp(feats, w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """feats f32 [B, F] + MLP params (w0 [F,H], w1 [H,H], w2 [H,1]) ->
    sigmoid scores f32 [B]."""
    b, f = feats.shape
    h = w0.shape[1]
    shapes = {"w0": (w0, (f, h)), "b0": (b0, (h,)), "w1": (w1, (h, h)),
              "b1": (b1, (h,)), "w2": (w2, (h, 1)), "b2": (b2, (1,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if _build.device_kind(feats, "scorer_mlp") == "cpu":
        return scorer_mlp_plain(feats, w0, b0, w1, b1, w2, b2)
    args = [feats] + [t for t, _ in shapes.values()]
    for t in args:
        if t.dtype != torch.float32 or t.device != feats.device:
            raise TypeError("scorer_mlp takes float32 tensors on one device")
    args = [t.contiguous() for t in args]
    max_h = _build.function("scorer_mlp", "scorer_mlp_max_hidden", [])()
    if h > max_h:
        raise ValueError(f"hidden width {h} exceeds the kernel's {max_h}")
    out = torch.empty((b,), dtype=torch.float32, device=feats.device)
    launch = _build.function("scorer_mlp", "scorer_mlp_launch", _ARGTYPES)
    with torch.cuda.device(feats.device):
        code = launch(*map(_build.ptr, args), _build.ptr(out), b, f, h,
                      _build.stream_of(feats))
    _build.check(code, "scorer_mlp", "scorer_mlp launch")
    scorer_mlp.launches += 1
    return out


scorer_mlp.launches = 0
