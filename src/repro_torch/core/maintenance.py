"""Maintenance knobs of the maintained graph and the concurrent
maintenance plane (port of ``repro/core/maintenance.py``):
``MaintenanceConfig``, carried by ``GusConfig.maintenance`` (canonical:
``DynamicGUS`` pushes it down into ``GraphConfig.maintenance``) or by
``GraphConfig.maintenance`` alone.

The port keeps the two knobs its graph path reads. The reference's
sharded-backend knobs (``compact``, ``headroom``, ``soar``, ``resplit``,
``resplit_metric``) wait for the sharded backend; its one-release
deprecation shims (``resolve_legacy``, ``GraphConfig.repair_per_batch``)
exist only for old in-repo spellings and are not ported. The
``SnapshotStateful`` contract is kept by name: the feature store, both
indexes, the graph store, the multi-modal store and ``DynamicGUS`` each
have ``snapshot_state() -> dict`` (host arrays only) and
``restore_state(state)``, and the engine composes them.

``staleness_bound`` is measured in applied mutation batches and bounds how
far the published graph version that serving reads may lag the freshest
applied state; 0 (the default) serves the live graph and keeps the
pipeline bitwise with the synchronous path, > 0 turns on the concurrent
maintenance plane (``serve/maintenance.py``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MaintenanceConfig:
    """Knobs for graph upkeep.

    staleness_bound: max batches the published graph version serving
        reads may lag the freshest applied state; 0 = serve the live graph.
    repair_per_tick: graph repair re-queries drained per maintenance tick.
    """

    staleness_bound: int = 0
    repair_per_tick: int = 256

    def __post_init__(self):
        if self.staleness_bound < 0:
            raise ValueError(
                f"staleness_bound={self.staleness_bound} must be >= 0")
