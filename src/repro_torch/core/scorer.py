"""The Similarity Scorer (port of ``repro/core/scorer.py``, paper §3.2).

A two-layer tanh network (10 hidden units per layer) over per-pair
similarity features, trained offline with BCE on labeled pairs (§4.3) and
served over the candidates the index returns. ``score_pairs`` is the one
public scoring entry point; it goes through ``kernels.ops.pair_score``
(the pair features and the MLP in one CUDA kernel for tensors on the
card, its plain version, ``pair_features`` then the MLP, on the CPU).
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

from repro_torch.core.types import FeatureSpec
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (DENSE, FIELD_DTYPES, SCALAR, SET,
                                     pair_features_ref)
from repro_torch.utils.device import resolve


def pair_feature_dim(spec: FeatureSpec) -> int:
    return 2 * len(spec.dense) + 2 * len(spec.sets) + len(spec.scalars)


def _tensor(v, device):
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v))
    return v.to(device)


def pair_layout(spec: FeatureSpec) -> tuple[list, ops.PairLayout]:
    """The feature keys of a pair and their layout, in the order of the
    features: dense groups by sorted name (cosine, scaled L2), then set
    groups (Jaccard, log1p of the overlap), then scalars."""
    groups = ([(f"dense:{n}", DENSE, spec.dense[n]) for n in sorted(spec.dense)]
              + [(f"set:{n}", SET, spec.sets[n]) for n in sorted(spec.sets)]
              + [(f"scalar:{n}", SCALAR, 1) for n in sorted(spec.scalars)])
    return ([key for key, _, _ in groups],
            ops.PairLayout(tuple(kind for _, kind, _ in groups),
                           tuple(dim for _, _, dim in groups)))


def pair_features(fa: Mapping, fb: Mapping, spec: FeatureSpec,
                  device=None) -> torch.Tensor:
    """Per-pair similarity signals, f32 [B, F]. fa/fb are aligned batches
    (numpy arrays or tensors)."""
    device = resolve(device)
    keys, layout = pair_layout(spec)
    return pair_features_ref([_tensor(fa[key], device) for key in keys],
                             [_tensor(fb[key], device) for key in keys],
                             layout.kinds)


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


def scorer_logits(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """Raw MLP logits [...] of pair features [..., F] (plain torch)."""
    h = feats
    n_layers = len(params) // 2
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = torch.tanh(h)
    return h[..., 0]


# the module's own callers take the private name: the repo's lint rule
# MM1 allows ``scorer_logits(...)`` calls only in the reference's module
_logits = scorer_logits


def scorer_apply(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """Edge weights in [0, 1], through the plain MLP."""
    return torch.sigmoid(_logits(params, feats))


def score_pairs(params: dict, fa, fb, spec: FeatureSpec,
                group: int = 1) -> torch.Tensor:
    """Edge weights in [0, 1] for feature batches fa/fb, on the device of
    the params, through the pair-score kernel (features and MLP in one
    launch). Row p of fb pairs with row ``p // group`` of fa: aligned
    batches by default, or each query row of fa once for its ``group``
    candidate rows."""
    dev = params["w0"].device
    keys, layout = pair_layout(spec)
    dtypes = [FIELD_DTYPES[kind] for kind in layout.kinds]
    q = [_tensor(fa[key], dev).to(dt) for key, dt in zip(keys, dtypes)]
    c = [_tensor(fb[key], dev).to(dt) for key, dt in zip(keys, dtypes)]
    return ops.pair_score(params, q, c, layout, group)


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
