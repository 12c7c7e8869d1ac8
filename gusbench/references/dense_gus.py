"""Plain reference of Dynamic GUS's dense path, for the configurations
whose points carry dense and scalar features: the paper's Embedding
Generator (SimHash and scalar buckets, unit IDF, no filter), the exact
sparse dot the index ranks by, the Similarity Scorer's pair features and
two-layer tanh network, and the scorer's offline training.

Written from the paper's description and the configuration alone, in
plain PyTorch and numpy: it imports nothing of the program and takes
nothing the program made. The 32-bit bucket hashes are computed in numpy
``uint64``, where a product of two 32-bit values is exact. ``precision``
is ``"exact"`` (float64: the judge) or ``"bf16"`` (the control: the same
arithmetic one precision below the float32 the configuration states).
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

PAD_INDEX = 0xFFFFFFFF
PAD_ITEM = -1
M32 = np.uint64(0xFFFFFFFF)
_GOLDEN = np.uint64(0x9E3779B9)
DTYPES = {"exact": torch.float64, "bf16": torch.bfloat16,
          "f32": torch.float32}


# ------------------------------------------------------------------ hashing

def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64).astype(np.uint64) & M32


def fmix32(x: np.ndarray) -> np.ndarray:
    x = _u32(x)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x85EBCA6B)) & M32
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & M32
    x ^= x >> np.uint64(16)
    return x


def combine(h, v) -> np.ndarray:
    h, v = _u32(h), _u32(v)
    mixed = (v + _GOLDEN + ((h << np.uint64(6)) & M32) + (h >> np.uint64(2)))
    return fmix32(h ^ (mixed & M32))


def hash_fields(*fields) -> np.ndarray:
    h = np.uint64(0x811C9DC5)
    for f in fields:
        h = combine(h, f)
    return h


def _tag(kind: str, name: str) -> int:
    return zlib.crc32(f"{kind}:{name}".encode())


# ---------------------------------------------------------------- embedding

def hyperplanes(dim: int, tables: int, bits: int, seed: int) -> torch.Tensor:
    """The configuration's SimHash planes [tables, dim, bits]: standard
    normals drawn on the CPU from ``torch.Generator().manual_seed(seed)``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn((tables, dim, bits), generator=gen, dtype=torch.float32)


def bucket_ids(features: dict, spec, buckets: dict, planes: dict,
               device, precision: str = "exact", block: int = 65536):
    """Bucket ids uint64 [N, K] of the points' features (dense modes by
    name, then sets, then scalars); sets are not part of this reference."""
    if spec.sets:
        raise ValueError("dense_gus has no set modes")
    dt = DTYPES[precision]
    cols = []
    for name, _dim in sorted(spec.dense):
        x = features[f"dense:{name}"]
        p = planes[name].to(device=device, dtype=dt)          # [T, D, bits]
        t_n, _, n_bits = p.shape
        weights = torch.tensor([1 << i for i in range(n_bits)],
                               dtype=torch.int64, device=device)
        codes = []
        for lo in range(0, x.shape[0], block):
            xb = torch.as_tensor(x[lo:lo + block]).to(device=device, dtype=dt)
            proj = torch.einsum("nd,tdb->tnb", xb, p)
            codes.append(((proj > 0).to(torch.int64) * weights).sum(-1).cpu())
        codes = torch.cat(codes, 1).numpy()                   # [T, N]
        tag = _tag("dense", name)
        for t in range(t_n):
            cols.append(hash_fields(tag, t, codes[t]))
    for name in sorted(spec.scalars):
        x = np.asarray(features[f"scalar:{name}"], np.float32)
        tag = _tag("scalar", name)
        for wi, width in enumerate(buckets["scalar_widths"]):
            bins = np.floor(x / np.float32(width)).astype(np.int32)
            cols.append(hash_fields(tag, wi, bins))
    return np.stack(cols, -1)


def sparse_rows(ids: np.ndarray):
    """Unit-weight sparse rows: each row's distinct bucket ids ascending,
    ``PAD_INDEX`` after them. Returns (idx int64 [N, K], nnz int64 [N])."""
    s = np.sort(ids, axis=1)
    dup = np.zeros_like(s, dtype=bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    s = np.where(dup, np.uint64(PAD_INDEX), s)
    s = np.sort(s, axis=1).astype(np.int64)
    return s, (s != PAD_INDEX).sum(1)


def embed(features: dict, spec, buckets: dict, planes: dict, device,
          precision: str = "exact") -> np.ndarray:
    """The sparse embedding's indices int64 [N, K] (unit values where not
    ``PAD_INDEX``): idf_size 0 and filter_percent 0 only."""
    if buckets.get("idf_size", 0) or buckets.get("filter_percent", 0):
        raise ValueError("dense_gus covers unit IDF weights and no filter")
    return sparse_rows(bucket_ids(features, spec, buckets, planes, device,
                                  precision))[0]


def dots(q_idx: torch.Tensor, db_idx: torch.Tensor) -> torch.Tensor:
    """Exact unit-weight sparse dots: shared bucket ids of query rows
    [Q, K] and database rows [N, K] (both distinct per row) -> int [Q, N]."""
    live = q_idx != PAD_INDEX
    eq = (q_idx[:, None, :, None] == db_idx[None, :, None, :]) \
        & live[:, None, :, None]
    return eq.sum((2, 3))


def pair_dots(a_idx: torch.Tensor, b_idx: torch.Tensor) -> torch.Tensor:
    """Row-aligned exact dots of [P, K] and [P, K] -> int [P]."""
    eq = (a_idx[:, :, None] == b_idx[:, None, :]) \
        & (a_idx != PAD_INDEX)[:, :, None]
    return eq.sum((1, 2))


# ------------------------------------------------------------------ scorer

def pair_features(fa: dict, fb: dict, spec, dt) -> torch.Tensor:
    """Per-pair signals [P, F] in ``dt``: per dense mode the cosine and the
    L2 distance over the sum of the norms (negated), per scalar minus the
    absolute difference."""
    out = []
    for name, _dim in sorted(spec.dense):
        a, b = fa[f"dense:{name}"].to(dt), fb[f"dense:{name}"].to(dt)
        na = torch.linalg.norm(a, dim=-1) + 1e-9
        nb = torch.linalg.norm(b, dim=-1) + 1e-9
        out.append((a * b).sum(-1) / (na * nb))
        out.append(-torch.linalg.norm(a - b, dim=-1) / (na + nb))
    for name in sorted(spec.scalars):
        a, b = fa[f"scalar:{name}"].to(dt), fb[f"scalar:{name}"].to(dt)
        out.append(-(a - b).abs())
    return torch.stack(out, -1)


def mlp(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """Logits of the two tanh layers and the linear head, in feats' dtype."""
    dt = feats.dtype
    h = torch.tanh(feats @ params["w0"].to(dt) + params["b0"].to(dt))
    h = torch.tanh(h @ params["w1"].to(dt) + params["b1"].to(dt))
    return (h @ params["w2"].to(dt) + params["b2"].to(dt))[..., 0]


def pair_score(params: dict, fa: dict, fb: dict, spec,
               precision: str = "exact") -> torch.Tensor:
    """Edge weights sigmoid(mlp(pair features)) [P], float64 out."""
    dt = DTYPES[precision]
    return torch.sigmoid(mlp(params, pair_features(fa, fb, spec, dt))).double()


def train_scorer(feats: torch.Tensor, labels: torch.Tensor, *, seed: int,
                 hidden: int, steps: int, batch: int, lr: float,
                 device) -> dict:
    """The scorer's offline training (paper §4.3) in float32: He-normal
    init from ``torch.Generator().manual_seed(seed)``, AdamW (betas 0.9,
    0.95, no decay), global-norm clip 1.0, BCE on logits, batches taken in
    order."""
    gen = torch.Generator().manual_seed(int(seed))
    dims = [feats.shape[1], hidden, hidden, 1]
    params = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((d_in, d_out), generator=gen) * (2.0 / d_in) ** 0.5
        params[f"w{i}"] = w.to(device).requires_grad_(True)
        params[f"b{i}"] = torch.zeros((d_out,), device=device,
                                      requires_grad=True)
    opt = torch.optim.AdamW(list(params.values()), lr=lr, betas=(0.9, 0.95),
                            eps=1e-8, weight_decay=0.0)
    feats = feats.to(device, torch.float32)
    labels = labels.to(device, torch.float32)
    n = feats.shape[0]
    for step in range(steps):
        lo = (step * batch) % max(n - batch, 1)
        logits = mlp(params, feats[lo:lo + batch])
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            logits, labels[lo:lo + batch])
        opt.zero_grad()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(list(params.values()), 1.0)
        opt.step()
    return {k: v.detach() for k, v in params.items()}
