"""AdamW with schedules and global-norm clipping (port of
``repro/train/optimizer.py``).

The state is the reference's ``{step, m, v}`` tree, the moments in
``moment_dtype`` (f32, or bf16 where f32 moments do not fit: 8 bytes a
param). ``adamw_update`` has the reference's formula and cast order: each
step's scalars are 0-d f32 tensors as the reference's are, and each
element goes g, m, v, p -> f32 -> update -> its own dtype. It updates the
params and moments in place, over flat slices of at most
``utils.tree.SLICE`` elements (2^26): the update is elementwise, so the
result is the whole-leaf formula's bit for bit, while the f32
temporaries stay at about 1.3 GB where a whole stacked FFN matrix of
qwen3-8b would need 36 GB of them. ``clip_by_global_norm`` scales the
grads in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.configs.base import DTYPES
from repro_torch.utils.tree import flat_slices, global_norm, leaves, tree_map

F32 = torch.float32


def moment_dtype(dtype) -> torch.dtype:
    """A torch dtype from the reference's names ("float32", "bfloat16")
    or a torch dtype."""
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = 1.0
    moment_dtype: torch.dtype | str = torch.float32


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """The reference's schedule, in f32: linear warm-up to ``peak_lr``,
    then a cosine down to ``floor * peak_lr`` at ``total``. ``step`` is a
    number or a tensor; the result is a 0-d f32 tensor on its device."""
    def schedule(step):
        step = torch.as_tensor(step).to(F32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return schedule


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """``{step: int32 0, m, v}``: zero moments like ``params`` in
    ``cfg.moment_dtype``, on the params' device."""
    dtype = moment_dtype(cfg.moment_dtype)
    zeros = lambda: tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                                   device=p.device), params)
    dev = leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": zeros(), "v": zeros()}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place by min(1, max_norm / norm) (the scale cast
    to each leaf's dtype, as the reference casts it); -> (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def update_leaf(p, g, m, v, k: dict, wd: float, eps: float) -> None:
    """The reference's ``upd`` of one leaf (or one slice of it) with the
    scalars ``k`` of ``step_scalars``, written back in place."""
    g32 = g.float()
    m32 = m.float() * k["b1"] + k["1-b1"] * g32
    v32 = v.float() * k["b2"] + k["1-b2"] * g32 * g32
    step_dir = (m32 / k["bc1"]) / (torch.sqrt(v32 / k["bc2"]) + eps)
    if wd:
        step_dir = step_dir + wd * p.float()
    new_p = p.float() - k["lr"] * step_dir
    p.copy_(new_p)
    m.copy_(m32)
    v.copy_(v32)


def step_scalars(step: torch.Tensor, cfg: AdamWConfig) -> dict:
    """The update's f32 scalars at ``step`` (the new step count), as the
    reference forms them: ``lr``, ``b1``, ``b2``, ``1 - b1``, ``1 - b2``
    and the bias corrections ``bc1``, ``bc2``."""
    dev = step.device
    lr = (cfg.lr(step) if callable(cfg.lr)
          else torch.tensor(cfg.lr, dtype=F32, device=dev))
    b1 = torch.tensor(cfg.b1, dtype=F32, device=dev)
    b2 = torch.tensor(cfg.b2, dtype=F32, device=dev)
    s = step.to(F32)
    return {"lr": lr.to(F32), "b1": b1, "b2": b2, "1-b1": 1 - b1,
            "1-b2": 1 - b2, "bc1": 1 - b1 ** s, "bc2": 1 - b2 ** s}


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig):
    """One AdamW step. Returns (params, state, metrics); the params and
    moments are updated in place (``grads`` too, where clipping scales
    them), the step count is a new tensor."""
    metrics = {}
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = gnorm
    step = state["step"] + 1
    k = step_scalars(step, cfg)
    metrics["lr"] = k["lr"]
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        for ps, gs, ms, vs in zip(flat_slices(p), flat_slices(g),
                                  flat_slices(m), flat_slices(v)):
            update_leaf(ps, gs, ms, vs, k, cfg.weight_decay, cfg.eps)
    return params, {"step": step, "m": state["m"], "v": state["v"]}, metrics
