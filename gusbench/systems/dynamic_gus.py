"""The system under test: ``repro_torch.core.gus.DynamicGUS`` built from a
configuration file (the index RPCs, no maintained graph), driven through
its two RPCs (``neighbors_of_ids`` and ``mutate``), and read back after
the window for the comparison.

This is the only file of the benchmark that imports the program.
"""
from __future__ import annotations

import numpy as np
import torch


class System:
    """One ``DynamicGUS`` on one device, as the configuration states it."""

    def __init__(self, cfg: dict, spec, scorer_params: dict, lsh_seed: int,
                 device):
        from repro_torch.ann.scann import ScannConfig
        from repro_torch.core.buckets import BucketConfig
        from repro_torch.core.gus import DynamicGUS, GusConfig
        from repro_torch.core.types import FeatureSpec

        ix, bk = cfg["index"], cfg["buckets"]
        if ix["backend"] != "scann":
            raise ValueError(f"dynamic_gus runs the scann backend, not "
                             f"{ix['backend']!r}")
        self.spec = FeatureSpec(dense=dict(spec.dense), sets=dict(spec.sets),
                                scalars=tuple(spec.scalars))
        buckets = BucketConfig(
            dense_tables=bk["dense_tables"], dense_bits=bk["dense_bits"],
            set_tables=bk["set_tables"],
            scalar_widths=tuple(bk["scalar_widths"]), seed=lsh_seed)
        scann = ScannConfig(
            d_proj=ix["d_proj"], n_partitions=ix["n_partitions"],
            pq_subspaces=ix["pq_subspaces"], pq_centers=ix["pq_centers"],
            nprobe=ix["nprobe"], reorder=ix["reorder"], eta=ix["eta"],
            soar_lambda=ix["soar_lambda"], kmeans_iters=ix["kmeans_iters"],
            pq_iters=ix["pq_iters"], fused=ix["fused"],
            pq_int8=ix["pq_int8"], seed=ix["seed"])
        if cfg.get("graph") is not None:
            raise ValueError("dynamic_gus serves no maintained graph")
        gcfg = GusConfig(scann_nn=ix["scann_nn"], idf_size=bk["idf_size"],
                         filter_percent=bk["filter_percent"], backend="scann",
                         scann=scann)
        self.device = torch.device(device)
        self.gus = DynamicGUS(self.spec, buckets, scorer_params, gcfg,
                              device=self.device)

    # ------------------------------------------------------------- the RPCs

    def bootstrap(self, ids: np.ndarray, features: dict) -> None:
        self.gus.bootstrap(ids, features)

    def query(self, ids: np.ndarray, k: int):
        """The neighborhood RPC: (ids, weights, distances) numpy [B, k]."""
        r = self.gus.neighbors_of_ids(ids, k)
        return r.ids, r.weights, r.distances

    def mutate(self, batch) -> int:
        """The mutation RPC."""
        from repro_torch.core.types import MutationBatch
        return self.gus.mutate(MutationBatch(kinds=batch.kinds, ids=batch.ids,
                                             features=batch.features))

    # ------------------------------------------------------ after the window

    def counters(self) -> dict:
        """The program's own timers (ms samples) and sizes."""
        g = self.gus
        return {"mutation_timer_ms": list(g.mutation_timer.samples_ms),
                "query_timer_ms": list(g.query_timer.samples_ms),
                "slab": int(g.index.slab),
                "capacity": int(g.index.capacity)}

    def mark(self) -> dict:
        """Lengths of the timers' sample lists, to cut a window's out."""
        g = self.gus
        return {"mutation": len(g.mutation_timer.samples_ms),
                "query": len(g.query_timer.samples_ms)}

    def read_state(self) -> dict:
        """The state the acknowledged mutations left, copied to the host:
        the index's id -> slot map, the stored rows of those slots, every
        valid partition entry's slot."""
        ix = self.gus.index
        live = np.fromiter(ix.slot_of, np.int64, len(ix.slot_of))
        slots = np.asarray([rec[0] for rec in ix.slot_of.values()], np.int64)
        sl = torch.as_tensor(slots, device=ix.device)
        rows = ix.sp_idx[sl].cpu().numpy()
        vals = ix.sp_val[sl].cpu().numpy()
        entries = ix.members[ix.valid_list].cpu().numpy().astype(np.int64)
        out = {"index_ids": live, "index_slots": slots,
               "index_rows": np.where(vals != 0, rows, 0xFFFFFFFF),
               "index_entry_slots": entries,
               "index_slot_ids": ix.ids.copy(),
               "soar": bool(ix.cfg.use_soar)}
        return out

    def close(self) -> None:
        """Drop the program's device state."""
        self.gus = None
