"""Core data types for Dynamic GUS (port of ``repro/core/types.py``).

Sparse embeddings keep the reference's fixed-nnz padded layout. Bucket
indices are uint32 values held in int64 tensors: torch has no working
uint32 arithmetic, and in int64 the ``PAD_INDEX`` sentinel (2^32 - 1)
still sorts after every real index, as it does in uint32.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

# Padding sentinel for sparse dims: max uint32, sorts to the end, value 0.
PAD_INDEX = 0xFFFFFFFF
# Padding sentinel for set-feature items (absent item).
PAD_ITEM = -1


@dataclasses.dataclass(frozen=True, eq=False)
class FeatureSpec:
    """Schema of the multimodal features attached to every point.

    dense:   mode name -> embedding dimension (float vectors)
    sets:    mode name -> max item count (padded int32 id lists, PAD_ITEM pad)
    scalars: tuple of scalar mode names (float)
    """
    dense: Mapping[str, int] = dataclasses.field(default_factory=dict)
    sets: Mapping[str, int] = dataclasses.field(default_factory=dict)
    scalars: tuple = ()

    def _key(self):
        return (tuple(sorted(self.dense.items())),
                tuple(sorted(self.sets.items())), tuple(self.scalars))

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, FeatureSpec) and self._key() == other._key()

    def feature_shapes(self, batch: int) -> dict:
        """Feature key -> (shape, numpy dtype) for a batch of points."""
        shapes = {}
        for name, dim in self.dense.items():
            shapes[f"dense:{name}"] = ((batch, dim), np.dtype(np.float32))
        for name, cap in self.sets.items():
            shapes[f"set:{name}"] = ((batch, cap), np.dtype(np.int32))
        for name in self.scalars:
            shapes[f"scalar:{name}"] = ((batch,), np.dtype(np.float32))
        return shapes

    def validate(self, features: Mapping) -> None:
        """Raise unless ``features`` holds exactly this spec's keys."""
        want = set(self.feature_shapes(1))
        have = set(features)
        if want != have:
            raise ValueError(f"feature keys mismatch: want {sorted(want)}, "
                             f"have {sorted(have)}")


@dataclasses.dataclass
class SparseBatch:
    """Fixed-nnz padded sparse embeddings: one row per point.

    indices: int64 [B, K] holding uint32 values, sorted ascending per row,
             PAD_INDEX padding
    values:  float32 [B, K], 0.0 at padding (and at filtered dims)
    """
    indices: torch.Tensor
    values: torch.Tensor

    @property
    def batch(self) -> int:
        return self.indices.shape[0]

    @property
    def k(self) -> int:
        return self.indices.shape[1]

    def nnz(self) -> torch.Tensor:
        """Live entries per row: not padding and not a zero value."""
        return ((self.indices != PAD_INDEX) & (self.values != 0.0)).sum(-1)

    def __getitem__(self, sl) -> "SparseBatch":
        return SparseBatch(self.indices[sl], self.values[sl])


def sort_sparse(indices: torch.Tensor, values: torch.Tensor) -> SparseBatch:
    """Canonicalize: zero-value dims -> PAD_INDEX, then sort rows by index
    (stable, as ``jnp.argsort`` is)."""
    indices = torch.where(values == 0.0, PAD_INDEX, indices.to(torch.int64))
    order = torch.argsort(indices, dim=-1, stable=True)
    return SparseBatch(torch.gather(indices, -1, order),
                       torch.gather(values, -1, order))


@dataclasses.dataclass
class NeighborResult:
    """Answer to a neighborhood RPC (paper §3.3.3).

    ids/weights are padded to the request's k with id=-1, weight=-inf.
    ``weights`` are model similarity scores, ``distances`` are the embedding
    -dot distances from the ANN stage.
    """
    ids: np.ndarray        # int64 [B, k]
    weights: np.ndarray    # float32 [B, k]
    distances: np.ndarray  # float32 [B, k]


MUTATION_INSERT = 0
MUTATION_UPDATE = 1
MUTATION_DELETE = 2


@dataclasses.dataclass
class MutationBatch:
    """A batch of mutation RPCs: kind in {insert, update, delete}."""
    kinds: np.ndarray            # int32 [B]
    ids: np.ndarray              # int64 [B]
    features: Mapping[str, np.ndarray] | None  # None for pure deletes
