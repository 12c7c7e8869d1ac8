"""IDF weighting and popular-bucket filtering (port of ``repro/core/idf.py``,
paper §4.2, §4.3).

Both tables are built on the host in numpy (the same code as the
reference, so the tables are bitwise equal given the same bucket counts)
and kept on the device as sorted int64 arrays, consulted with
``torch.searchsorted`` when embeddings are generated. ``IdfCounts`` keeps
the bucket counts incrementally from the mutation stream, for the
multi-modal store's routing tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils.device import resolve


@dataclasses.dataclass
class IdfTable:
    sorted_ids: torch.Tensor      # int64 [S] of uint32 values, ascending
    weights: torch.Tensor         # float32 [S]
    default_weight: torch.Tensor  # float32 []

    @staticmethod
    def disabled(device=None) -> "IdfTable":
        """IDF-S = 0: unit weights everywhere (the paper's base embedding)."""
        device = resolve(device)
        return IdfTable(torch.zeros(0, dtype=torch.int64, device=device),
                        torch.zeros(0, dtype=torch.float32, device=device),
                        torch.ones((), dtype=torch.float32, device=device))

    def lookup(self, bucket_ids: torch.Tensor) -> torch.Tensor:
        if self.sorted_ids.shape[0] == 0:
            return self.default_weight.expand(bucket_ids.shape)
        pos = torch.searchsorted(self.sorted_ids, bucket_ids)
        pos = pos.clamp(max=self.sorted_ids.shape[0] - 1)
        hit = self.sorted_ids[pos] == bucket_ids
        return torch.where(hit, self.weights[pos], self.default_weight)


@dataclasses.dataclass
class FilterTable:
    sorted_ids: torch.Tensor      # int64 [F] of uint32 values, ascending

    @staticmethod
    def disabled(device=None) -> "FilterTable":
        return FilterTable(torch.zeros(0, dtype=torch.int64,
                                       device=resolve(device)))

    def keep_mask(self, bucket_ids: torch.Tensor) -> torch.Tensor:
        if self.sorted_ids.shape[0] == 0:
            return torch.ones(bucket_ids.shape, dtype=torch.bool,
                              device=bucket_ids.device)
        pos = torch.searchsorted(self.sorted_ids, bucket_ids)
        pos = pos.clamp(max=self.sorted_ids.shape[0] - 1)
        return self.sorted_ids[pos] != bucket_ids


def bucket_counts(bucket_ids: np.ndarray, valid: np.ndarray) -> tuple:
    """Corpus statistics: unique bucket IDs and their document counts."""
    flat = np.asarray(bucket_ids)[np.asarray(valid)]
    return np.unique(flat, return_counts=True)


def idf_table_from_counts(uniq: np.ndarray, counts: np.ndarray,
                          n_points: int, size: int, device=None) -> IdfTable:
    """IDF-S table from precomputed (uniq, counts) bucket statistics."""
    device = resolve(device)
    if size <= 0:
        return IdfTable.disabled(device)
    idf = np.log(np.maximum(n_points, 1) / counts.astype(np.float64))
    if uniq.size > size:
        top = np.argpartition(-idf, size - 1)[:size]
        uniq, idf = uniq[top], idf[top]
    default = float(idf.min()) if idf.size else 0.0
    order = np.argsort(uniq)
    return IdfTable(
        torch.as_tensor(uniq[order].astype(np.int64), device=device),
        torch.as_tensor(idf[order].astype(np.float32), device=device),
        torch.tensor(default, dtype=torch.float32, device=device))


def filter_table_from_counts(uniq: np.ndarray, counts: np.ndarray,
                             percent: float, device=None) -> FilterTable:
    """Filter-P table from precomputed (uniq, counts) bucket statistics."""
    device = resolve(device)
    if percent <= 0:
        return FilterTable.disabled(device)
    n_drop = int(np.ceil(uniq.size * percent / 100.0))
    if n_drop == 0:
        return FilterTable.disabled(device)
    top = np.argpartition(-counts, min(n_drop, counts.size) - 1)[:n_drop]
    return FilterTable(torch.as_tensor(np.sort(uniq[top]).astype(np.int64),
                                       device=device))


def build_idf_table(bucket_ids: np.ndarray, valid: np.ndarray,
                    n_points: int, size: int, device=None) -> IdfTable:
    """IDF-S = ``size`` table from a corpus snapshot (size=0 disables)."""
    if size <= 0:
        return IdfTable.disabled(device)
    uniq, counts = bucket_counts(bucket_ids, valid)
    return idf_table_from_counts(uniq, counts, n_points, size, device)


def build_filter_table(bucket_ids: np.ndarray, valid: np.ndarray,
                       percent: float, device=None) -> FilterTable:
    """Filter-P = ``percent`` table: drop the most popular percent% of IDs."""
    if percent <= 0:
        return FilterTable.disabled(device)
    uniq, counts = bucket_counts(bucket_ids, valid)
    return filter_table_from_counts(uniq, counts, percent, device)


class IdfCounts:
    """Incremental corpus bucket statistics maintained from the mutation
    stream (the online counterpart of §4.3's offline preprocessing; port
    of ``repro/core/idf.py::IdfCounts``).

    Tracks, on the host, the occurrence count of every valid bucket cell
    (the statistic of ``bucket_counts`` over the full corpus, duplicates
    within a row included) and the number of live points. ``idf_table`` /
    ``filter_table`` go through ``idf_table_from_counts`` /
    ``filter_table_from_counts``, so they are bitwise equal to a
    from-scratch ``build_idf_table`` / ``build_filter_table`` over the
    same corpus.
    """

    def __init__(self) -> None:
        self._counts: dict[int, int] = {}
        self.n_points = 0

    def add(self, bucket_ids: np.ndarray, valid: np.ndarray) -> None:
        """Count one batch of points' bucket rows ([B, k] + valid mask)."""
        bucket_ids = np.asarray(bucket_ids)
        counts = self._counts
        for b in bucket_ids[np.asarray(valid)].tolist():
            counts[b] = counts.get(b, 0) + 1
        self.n_points += int(bucket_ids.shape[0])

    def remove(self, bucket_ids: np.ndarray, valid: np.ndarray) -> None:
        """Undo ``add`` for points leaving the corpus (delete / re-update)."""
        bucket_ids = np.asarray(bucket_ids)
        counts = self._counts
        for b in bucket_ids[np.asarray(valid)].tolist():
            c = counts.get(b, 0) - 1
            if c <= 0:
                counts.pop(b, None)
            else:
                counts[b] = c
        self.n_points -= int(bucket_ids.shape[0])

    def arrays(self) -> tuple:
        """(uniq ascending uint32, counts int64): ``bucket_counts``' shape."""
        uniq = np.array(sorted(self._counts), np.uint32)
        counts = np.array([self._counts[int(b)] for b in uniq], np.int64)
        return uniq, counts

    def idf_table(self, size: int, device=None) -> IdfTable:
        uniq, counts = self.arrays()
        return idf_table_from_counts(uniq, counts, self.n_points, size,
                                     device)

    def filter_table(self, percent: float, device=None) -> FilterTable:
        uniq, counts = self.arrays()
        return filter_table_from_counts(uniq, counts, percent, device)

    def snapshot_state(self) -> dict:
        uniq, counts = self.arrays()
        return {"ids": uniq, "counts": counts, "n_points": self.n_points}

    def restore_state(self, state: dict) -> None:
        ids = np.asarray(state["ids"]).tolist()
        counts = np.asarray(state["counts"]).tolist()
        self._counts = dict(zip((int(b) for b in ids),
                                (int(c) for c in counts)))
        self.n_points = int(state["n_points"])
