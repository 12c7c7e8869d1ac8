"""The Embedding Generator (port of ``repro/core/embedding.py``, paper
§3.2, §4.1): features --LSH--> bucket IDs --(filter, IDF)--> sparse
embedding. A pure function of the point's own features plus two small
precomputed tables, shared by the mutation and neighborhood paths.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.buckets import (BucketConfig, generate_buckets,
                                      make_bucket_params)
from repro_torch.core.idf import FilterTable, IdfTable
from repro_torch.core.types import FeatureSpec, SparseBatch, sort_sparse
from repro_torch.utils.device import resolve


def as_features(features: Mapping, device) -> dict:
    """Feature dict (numpy or tensors) -> tensors on ``device``."""
    out = {}
    for k, v in features.items():
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        out[k] = v.to(device)
    return out


@dataclasses.dataclass
class EmbeddingGenerator:
    spec: FeatureSpec
    cfg: BucketConfig
    params: dict
    idf: IdfTable
    filter: FilterTable
    device: torch.device

    @staticmethod
    def create(spec: FeatureSpec, cfg: BucketConfig,
               device=None) -> "EmbeddingGenerator":
        """A generator with fresh hyperplanes and the tables disabled
        (``reload`` installs them)."""
        device = resolve(device)
        return EmbeddingGenerator(
            spec=spec, cfg=cfg, params=make_bucket_params(spec, cfg, device),
            idf=IdfTable.disabled(device),
            filter=FilterTable.disabled(device), device=device)

    def reload(self, idf: IdfTable | None = None,
               filter_table: FilterTable | None = None
               ) -> "EmbeddingGenerator":
        """Hot-swap the precomputed tables (paper §4.3 periodic reload)."""
        return dataclasses.replace(
            self, idf=idf if idf is not None else self.idf,
            filter=filter_table if filter_table is not None else self.filter)

    @property
    def k_max(self) -> int:
        return self.cfg.k_max(self.spec)

    def buckets(self, features: Mapping):
        return generate_buckets(as_features(features, self.device),
                                self.spec, self.cfg, self.params)

    def __call__(self, features: Mapping) -> SparseBatch:
        return embed_batch(as_features(features, self.device), self.spec,
                           self.cfg, self.params, self.idf, self.filter)


def embed_batch(features, spec: FeatureSpec, cfg: BucketConfig, params,
                idf: IdfTable, filter_table: FilterTable) -> SparseBatch:
    bucket_ids, valid = generate_buckets(features, spec, cfg, params)
    weights = idf.lookup(bucket_ids)
    keep = filter_table.keep_mask(bucket_ids) & valid
    values = torch.where(keep, weights, 0.0).to(torch.float32)

    # Dedup within a row (a bucket ID is a *set* member in Grale): sort by
    # index, zero out repeats, then re-canonicalize so padding sorts last.
    first = sort_sparse(bucket_ids, values)
    dup = torch.zeros_like(first.indices, dtype=torch.bool)
    dup[:, 1:] = first.indices[:, 1:] == first.indices[:, :-1]
    values = torch.where(dup, 0.0, first.values)
    return sort_sparse(first.indices, values)
