"""Dynamic mutation streams (numpy-only copy of ``repro/data/stream.py``,
paper §5.2's "dynamic environment").

A reproducible interleaved stream of insert / update / delete mutations
plus neighborhood queries over a synthetic corpus; the same seed gives the
reference and the port the same batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import (MutationBatch, MUTATION_DELETE,
                                    MUTATION_INSERT, MUTATION_UPDATE)
from repro_torch.data.synthetic import SyntheticConfig, make_dataset


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    insert_frac: float = 0.6
    update_frac: float = 0.25   # delete_frac = 1 - insert - update
    batch_size: int = 64
    seed: int = 0


class MutationStream:
    """Iterator of MutationBatch over a held-out portion of a dataset.

    ``bootstrap_fraction`` of the corpus is returned for offline bootstrap;
    the rest arrives as inserts, mixed with updates/deletes of live points.
    """

    def __init__(self, data_cfg: SyntheticConfig, stream_cfg: StreamConfig,
                 bootstrap_fraction: float = 0.5):
        self.cfg = stream_cfg
        ids, features, cluster = make_dataset(data_cfg)
        self.features = features
        self.cluster = cluster
        n_boot = int(len(ids) * bootstrap_fraction)
        self.boot_ids = ids[:n_boot]
        self.pending = list(ids[n_boot:].tolist())
        self.live = set(self.boot_ids.tolist())
        self.rng = np.random.default_rng(stream_cfg.seed)
        self.next_fresh_id = int(ids.max()) + 1

    def bootstrap(self):
        feats = {k: v[self.boot_ids] for k, v in self.features.items()}
        return self.boot_ids, feats

    def _features_of(self, ids: np.ndarray, jitter: float = 0.0) -> dict:
        base = {k: np.array(v[ids % v.shape[0]]) for k, v in self.features.items()}
        if jitter > 0:
            for k in base:
                if k.startswith("dense:"):
                    base[k] = base[k] + jitter * self.rng.normal(
                        size=base[k].shape).astype(np.float32)
        return base

    def __iter__(self):
        return self

    def __next__(self) -> MutationBatch:
        cfg = self.cfg
        kinds, ids = [], []
        live_list = list(self.live)
        for _ in range(cfg.batch_size):
            u = self.rng.random()
            if u < cfg.insert_frac or len(live_list) < 4:
                if self.pending:
                    pid = self.pending.pop()
                else:
                    pid = self.next_fresh_id
                    self.next_fresh_id += 1
                kinds.append(MUTATION_INSERT)
                ids.append(pid)
                self.live.add(pid)
                live_list.append(pid)
            elif u < cfg.insert_frac + cfg.update_frac:
                pid = live_list[self.rng.integers(len(live_list))]
                kinds.append(MUTATION_UPDATE)
                ids.append(pid)
            else:
                j = self.rng.integers(len(live_list))
                pid = live_list.pop(j)
                self.live.discard(pid)
                kinds.append(MUTATION_DELETE)
                ids.append(pid)
        ids_np = np.asarray(ids, np.int64)
        feats = self._features_of(ids_np, jitter=0.05)
        return MutationBatch(kinds=np.asarray(kinds, np.int32), ids=ids_np,
                             features=feats)

    def query_ids(self, n: int) -> np.ndarray:
        live_list = list(self.live)
        sel = self.rng.integers(0, len(live_list), n)
        return np.asarray([live_list[i] for i in sel], np.int64)

    def query_features(self, n: int) -> dict:
        """Feature rows for ``n`` neighborhood queries drawn from the live
        set — the serving front-end's read traffic."""
        return self._features_of(self.query_ids(n))
