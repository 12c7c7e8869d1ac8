"""LSH bucket-ID generation (port of ``repro/core/buckets.py``).

Each point gets a fixed number of bucket IDs: SimHash tables per dense
mode, MinHash tables per set mode, one quantization bucket per width per
scalar mode. IDs are uint32 hashes held in int64 (see ``core/types.py``)
and double as the sparse-embedding dimension indices (paper §4.1).

The SimHash signs come from a float32 einsum; the package turns TF32 off
for it (``repro_torch/__init__.py``), so a sign can differ from the
reference's only where the projection is within rounding of zero.

Everything after the projection (codes, MinHash minima, scalar bins and
their hashes) is ``kernels/buckets.py``: on the card two launches of the
CUDA source ``kernels/csrc/buckets.cu`` write every column, on the CPU
its plain version runs the column loop with ``core/hashing.py``'s
int64-emulated uint32 arithmetic. Both give the same ids bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.core.types import FeatureSpec
from repro_torch.kernels import buckets as kernel_buckets
from repro_torch.obs import stage
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
    IDs and must be masked by the caller. The SimHash projection is a
    float32 einsum; the columns come from ``kernels/buckets.py``: the
    SimHash and scalar columns in one call, then the set tables in
    another, in the stage ``embed.minhash``, which a schema without set
    modes does not open.
    """
    keys = ([f"dense:{n}" for n in sorted(spec.dense)]
            + [f"set:{n}" for n in sorted(spec.sets)]
            + [f"scalar:{n}" for n in sorted(spec.scalars)])
    first = features[keys[0]]
    ids = torch.empty((first.shape[0], cfg.k_max(spec)), dtype=torch.int64,
                      device=first.device)
    valid = torch.empty(ids.shape, dtype=torch.bool, device=first.device)

    projections = [torch.einsum("bd,tdk->tbk", features[f"dense:{name}"],
                                params[f"hyperplanes:{name}"])  # no TF32
                   for name in sorted(spec.dense)]           # [T, B, Bits]
    kernel_buckets.simhash_scalar_columns(
        projections, [features[f"scalar:{n}"] for n in sorted(spec.scalars)],
        spec, cfg, ids, valid)
    if spec.sets:
        with stage("embed.minhash", tables=len(spec.sets) * cfg.set_tables,
                   cap=max(spec.sets.values())):
            kernel_buckets.minhash_columns(
                [features[f"set:{n}"] for n in sorted(spec.sets)], spec,
                cfg, ids, valid)
    return ids, valid
