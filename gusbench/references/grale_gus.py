"""Plain reference of Dynamic GUS's multi-feature path, for the
configurations whose points carry any mix of dense, set and scalar
features: the paper's Embedding Generator (SimHash per dense mode, MinHash
per set mode, scalar buckets; unit IDF, no filter), the exact sparse dot
the index ranks by, the Similarity Scorer's pair features (dense modes,
then sets, then scalars) and two-layer tanh network, and the scorer's
offline training.

Written from the paper's description and the configuration alone, in
plain PyTorch and numpy: it imports nothing of the program and takes
nothing the program made. The dense and scalar columns, the hashing, the
sparse rows, the dots, the network and its training are
``references/dense_gus.py``'s. ``precision`` is ``"exact"`` (float64: the
judge) or ``"bf16"`` (the control); the MinHash columns are integer and
the same in both.

Where the description leaves a choice, this reference takes the
configuration's:

* A set table's MinHash is the minimum over the row's present items of
  a seeded 32-bit hash, ``fmix32(item * 0x9E3779B9 mod 2**32 ^
  fmix32(key))`` with ``key = seed * 131 + table`` mod 2**32 (``seed``
  the run's LSH seed); its bucket id hashes the mode's tag, the table and
  that minimum. A row with no item has no MinHash: its columns are
  ``PAD_INDEX``.
* The overlap of two set rows counts the pairs of equal present items,
  slot against slot, and the Jaccard is that overlap over the sum of the
  two rows' item counts less it (at least 1). For rows of distinct items
  these are the set intersection and the set Jaccard; the corpus may
  repeat an item within a row, and then each repeat counts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from references import dense_gus
from references.dense_gus import (DTYPES, M32, PAD_INDEX, PAD_ITEM, _GOLDEN,
                                  _tag, _u32, fmix32, hash_fields, mlp,
                                  sparse_rows)

# the judge's exact dots and the harness's scorer training are dense_gus'
dots, pair_dots, train_scorer = (dense_gus.dots, dense_gus.pair_dots,
                                 dense_gus.train_scorer)


def item_hash(key: int, items: np.ndarray) -> np.ndarray:
    """Seeded 32-bit hash of int items -> uint64 values below 2**32."""
    return fmix32((_u32(items) * _GOLDEN) & M32
                  ^ fmix32(np.uint64(int(key) & 0xFFFFFFFF)))


def minhash_ids(items: np.ndarray, name: str, tables: int,
                seed: int) -> list:
    """The bucket-id columns uint64 [N] of one set mode's ``tables``
    MinHash tables, ``PAD_INDEX`` where the row holds no item."""
    items = np.asarray(items)
    present = items != PAD_ITEM
    empty = ~present.any(-1)
    # each distinct item is hashed once per table
    uniq, inv = np.unique(items, return_inverse=True)
    inv = inv.reshape(items.shape)
    tag = _tag("set", name)
    cols = []
    for t in range(tables):
        h = item_hash(int(seed) * 131 + t, uniq)[inv]
        minh = np.where(present, h, M32).min(-1)
        cols.append(np.where(empty, np.uint64(PAD_INDEX),
                             hash_fields(tag, t, minh)))
    return cols


def bucket_ids(features: dict, spec, buckets: dict, planes: dict,
               device, precision: str = "exact") -> np.ndarray:
    """Bucket ids uint64 [N, K]: the dense and scalar columns of
    ``dense_gus``, then each set mode's MinHash columns."""
    cols = []
    plain = dataclasses.replace(spec, sets=())
    if plain.dense or plain.scalars:
        cols.append(dense_gus.bucket_ids(features, plain, buckets, planes,
                                         device, precision))
    for name, _cap in sorted(spec.sets):
        cols.append(np.stack(minhash_ids(
            features[f"set:{name}"], name, buckets["set_tables"],
            buckets["seed"]), -1))
    return np.concatenate(cols, -1)


def embed(features: dict, spec, buckets: dict, planes: dict, device,
          precision: str = "exact") -> np.ndarray:
    """The sparse embedding's indices int64 [N, K] (unit values where not
    ``PAD_INDEX``): idf_size 0 and filter_percent 0 only."""
    if buckets.get("idf_size", 0) or buckets.get("filter_percent", 0):
        raise ValueError("grale_gus covers unit IDF weights and no filter")
    return sparse_rows(bucket_ids(features, spec, buckets, planes, device,
                                  precision))[0]


def set_features(a: torch.Tensor, b: torch.Tensor, dt) -> list:
    """Jaccard and log1p of the overlap of aligned set rows [P, cap]."""
    va, vb = a != PAD_ITEM, b != PAD_ITEM
    inter = ((a[:, :, None] == b[:, None, :]) & va[:, :, None]
             & vb[:, None, :]).sum((1, 2)).to(dt)
    union = (va.sum(-1).to(dt) + vb.sum(-1).to(dt) - inter).clamp(min=1)
    return [inter / union, torch.log1p(inter)]


def pair_features(fa: dict, fb: dict, spec, dt) -> torch.Tensor:
    """Per-pair signals [P, F] in ``dt``: ``dense_gus``'s dense signals,
    each set mode's Jaccard and log1p of the overlap, then ``dense_gus``'s
    scalar signals."""
    out = []
    dense = dataclasses.replace(spec, sets=(), scalars=())
    if dense.dense:
        out.append(dense_gus.pair_features(fa, fb, dense, dt))
    for name, _cap in sorted(spec.sets):
        out.append(torch.stack(set_features(fa[f"set:{name}"],
                                            fb[f"set:{name}"], dt), -1))
    scalars = dataclasses.replace(spec, dense=(), sets=())
    if scalars.scalars:
        out.append(dense_gus.pair_features(fa, fb, scalars, dt))
    return torch.cat(out, -1)


def pair_score(params: dict, fa: dict, fb: dict, spec,
               precision: str = "exact") -> torch.Tensor:
    """Edge weights sigmoid(mlp(pair features)) [P], float64 out."""
    dt = DTYPES[precision]
    return torch.sigmoid(mlp(params, pair_features(fa, fb, spec, dt))).double()
