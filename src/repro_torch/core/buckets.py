"""LSH bucket-ID generation (port of ``repro/core/buckets.py``).

Each point gets a fixed number of bucket IDs: SimHash tables per dense
mode, MinHash tables per set mode, one quantization bucket per width per
scalar mode. IDs are uint32 hashes held in int64 (see ``core/types.py``)
and double as the sparse-embedding dimension indices (paper §4.1).

The SimHash signs come from a float32 einsum; the package turns TF32 off
for it (``repro_torch/__init__.py``), so a sign can differ from the
reference's only where the projection is within rounding of zero.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Mapping

import torch

from repro_torch.core import hashing
from repro_torch.core.types import FeatureSpec, PAD_ITEM
from repro_torch.utils.device import resolve


@dataclasses.dataclass(frozen=True)
class BucketConfig:
    """LSH shape of the bucket generator (per-mode table counts)."""
    dense_tables: int = 8          # SimHash tables per dense mode
    dense_bits: int = 12           # hyperplanes (bits) per table
    set_tables: int = 8            # MinHash tables per set mode
    scalar_widths: tuple = (1.0,)  # one quantization bucket per width
    seed: int = 0

    def k_max(self, spec: FeatureSpec) -> int:
        return (len(spec.dense) * self.dense_tables
                + len(spec.sets) * self.set_tables
                + len(spec.scalars) * len(self.scalar_widths))


def _mode_tag(kind: str, name: str) -> int:
    return zlib.crc32(f"{kind}:{name}".encode())


def make_bucket_params(spec: FeatureSpec, cfg: BucketConfig,
                       device=None) -> dict:
    """Random hyperplanes per dense mode, drawn on the CPU from a
    ``torch.Generator`` seeded with ``cfg.seed`` (device-independent)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    params = {}
    for name in sorted(spec.dense):
        dim = spec.dense[name]
        planes = torch.randn((cfg.dense_tables, dim, cfg.dense_bits),
                             generator=gen, dtype=torch.float32)
        params[f"hyperplanes:{name}"] = planes.to(resolve(device))
    return params


def generate_buckets(features: Mapping[str, torch.Tensor], spec: FeatureSpec,
                     cfg: BucketConfig, params: dict):
    """Bucket IDs for a batch of points.

    Returns (bucket_ids int64 [B, k_max] of uint32 values, valid bool
    [B, k_max]). Invalid slots (MinHash of an empty set) carry arbitrary
    IDs and must be masked by the caller.
    """
    ids, valid = [], []

    for name in sorted(spec.dense):
        x = features[f"dense:{name}"]
        planes = params[f"hyperplanes:{name}"]           # [T, D, Bits]
        proj = torch.einsum("bd,tdk->tbk", x, planes)    # float32, no TF32
        bits = (proj > 0).to(torch.int64)
        weights = torch.ones((), dtype=torch.int64, device=x.device) \
            << torch.arange(cfg.dense_bits, device=x.device)
        codes = (bits * weights).sum(-1)                 # [T, B]
        tag = _mode_tag("dense", name)
        for t in range(cfg.dense_tables):
            ids.append(hashing.hash_fields(tag, t, codes[t]))
            valid.append(torch.ones(x.shape[0], dtype=torch.bool,
                                    device=x.device))

    for name in sorted(spec.sets):
        items = features[f"set:{name}"]                  # int32 [B, cap]
        present = items != PAD_ITEM
        any_item = present.any(-1)
        tag = _mode_tag("set", name)
        for t in range(cfg.set_tables):
            hashed = hashing.uhash(cfg.seed * 131 + t, items)
            hashed = torch.where(present, hashed, hashing.M32)
            minh = hashed.amin(-1)                       # [B]
            ids.append(hashing.hash_fields(tag, t, minh))
            valid.append(any_item)

    for name in sorted(spec.scalars):
        x = features[f"scalar:{name}"]                   # f32 [B]
        tag = _mode_tag("scalar", name)
        for wi, width in enumerate(cfg.scalar_widths):
            bin_id = torch.floor(x / width).to(torch.int32)
            ids.append(hashing.hash_fields(tag, wi, bin_id))
            valid.append(torch.ones(x.shape[0], dtype=torch.bool,
                                    device=x.device))

    bucket_ids = torch.stack(ids, -1)                    # [B, k_max]
    valid_mask = torch.stack(valid, -1)
    if bucket_ids.shape[-1] != cfg.k_max(spec):
        raise ValueError("bucket count does not match BucketConfig.k_max")
    return bucket_ids, valid_mask
