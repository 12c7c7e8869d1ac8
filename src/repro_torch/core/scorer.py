"""The Similarity Scorer (port of ``repro/core/scorer.py``, paper §3.2).

A two-layer tanh network (10 hidden units per layer) over per-pair
similarity features, trained offline with BCE on labeled pairs (§4.3) and
served over the candidates the index returns. ``score_pairs`` is the one
public scoring entry point; it goes through ``kernels.ops.scorer_mlp``
(the CUDA kernel for tensors on the card, its plain version on the CPU).
``scorer_apply`` is the plain MLP of training.

``train_scorer`` runs PyTorch autograd through the plain MLP with AdamW
and a global gradient-norm clip of 1.0; the scorer kernel has no backward
(neither has the reference's Pallas kernel). Its init draws from a
``torch.Generator``, so trained weights differ from the reference's and
are judged by the loss falling.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.types import FeatureSpec, PAD_ITEM
from repro_torch.kernels import ops
from repro_torch.utils.device import resolve


def pair_feature_dim(spec: FeatureSpec) -> int:
    return 2 * len(spec.dense) + 2 * len(spec.sets) + len(spec.scalars)


def _tensor(v, device):
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v))
    return v.to(device)


def pair_features(fa: Mapping, fb: Mapping, spec: FeatureSpec,
                  device=None) -> torch.Tensor:
    """Per-pair similarity signals, f32 [B, F]. fa/fb are aligned batches
    (numpy arrays or tensors)."""
    device = resolve(device)
    feats = []
    for name in sorted(spec.dense):
        a = _tensor(fa[f"dense:{name}"], device)
        b = _tensor(fb[f"dense:{name}"], device)
        na = torch.linalg.norm(a, dim=-1) + 1e-9
        nb = torch.linalg.norm(b, dim=-1) + 1e-9
        feats.append((a * b).sum(-1) / (na * nb))                     # cosine
        feats.append(-torch.linalg.norm(a - b, dim=-1) / (na + nb))    # scaled L2
    for name in sorted(spec.sets):
        a = _tensor(fa[f"set:{name}"], device)
        b = _tensor(fb[f"set:{name}"], device)
        va, vb = a != PAD_ITEM, b != PAD_ITEM
        inter = ((a[:, :, None] == b[:, None, :]) & va[:, :, None]
                 & vb[:, None, :]).sum((1, 2)).to(torch.float32)
        size_a = va.sum(-1).to(torch.float32)
        size_b = vb.sum(-1).to(torch.float32)
        union = (size_a + size_b - inter).clamp(min=1.0)
        feats.append(inter / union)                                    # Jaccard
        feats.append(torch.log1p(inter))                               # overlap
    for name in sorted(spec.scalars):
        a = _tensor(fa[f"scalar:{name}"], device)
        b = _tensor(fb[f"scalar:{name}"], device)
        feats.append(-(a - b).abs())
    return torch.stack(feats, -1)


@dataclasses.dataclass(frozen=True)
class ScorerConfig:
    hidden: int = 10     # paper: two layers, 10 hidden units each
    layers: int = 2


def scorer_init(seed: int, spec: FeatureSpec, cfg: ScorerConfig = ScorerConfig(),
                device=None) -> dict:
    """He-normal weights from a ``torch.Generator`` seeded with ``seed``."""
    device = resolve(device)
    gen = torch.Generator().manual_seed(seed)
    dims = [pair_feature_dim(spec)] + [cfg.hidden] * cfg.layers + [1]
    params = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((d_in, d_out), generator=gen) * (2.0 / d_in) ** 0.5
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros((d_out,), device=device)
    return params


def _logits(params: dict, feats: torch.Tensor) -> torch.Tensor:
    h = feats
    n_layers = len(params) // 2
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = torch.tanh(h)
    return h[..., 0]


def scorer_apply(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """Edge weights in [0, 1], through the plain MLP."""
    return torch.sigmoid(_logits(params, feats))


def score_pairs(params: dict, fa, fb, spec: FeatureSpec) -> torch.Tensor:
    """Edge weights in [0, 1] for aligned feature batches fa/fb, on the
    device of the params, through the scorer kernel."""
    return ops.scorer_mlp(pair_features(fa, fb, spec, params["w0"].device),
                          params)


# ---------------------------------------------------------------- training

def bce_loss(params, feats, labels):
    logits = _logits(params, feats)
    return torch.mean(logits.clamp(min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def train_scorer(seed: int, spec: FeatureSpec, feats, labels, *,
                 cfg: ScorerConfig = ScorerConfig(), steps: int = 500,
                 batch: int = 1024, lr: float = 3e-3, device=None):
    """Offline scorer training (paper §4.3). feats: [N,F]; labels: [N].
    Returns (params, per-step losses)."""
    device = resolve(device)
    params = scorer_init(seed, spec, cfg, device)
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.AdamW(list(params.values()), lr=lr, betas=(0.9, 0.95),
                            eps=1e-8, weight_decay=0.0)
    feats = _tensor(feats, device).to(torch.float32)
    labels = _tensor(labels, device).to(torch.float32)
    n = feats.shape[0]
    losses = []
    for step in range(steps):
        lo = (step * batch) % max(n - batch, 1)
        loss = bce_loss(params, feats[lo:lo + batch], labels[lo:lo + batch])
        opt.zero_grad()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(list(params.values()), 1.0)
        opt.step()
        losses.append(loss.detach())
    return ({k: v.detach() for k, v in params.items()},
            [float(x) for x in torch.stack(losses).cpu()])
