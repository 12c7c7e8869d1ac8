"""Maintenance knobs of the index, the maintained graph and the concurrent
maintenance plane (port of ``repro/core/maintenance.py``):
``MaintenanceConfig``, carried by ``GusConfig.maintenance`` (canonical:
``DynamicGUS`` pushes it down into ``GraphConfig.maintenance`` and
``ShardedConfig.maintenance``) or by either of those alone.

The graph path reads ``staleness_bound`` and ``repair_per_tick``; the
sharded backend (``ann/sharded_index.py``) reads ``compact``,
``headroom``, ``soar``, ``resplit`` and ``resplit_metric``. The
reference's one-release deprecation shims (``resolve_legacy``, the legacy
``ShardedConfig`` fields, ``GraphConfig.repair_per_batch``) exist only
for old in-repo spellings and are not ported. ``SnapshotStateful`` is
the persistence contract: the feature store, the indexes, the graph
store, the multi-modal store, ``IdfCounts`` and ``DynamicGUS`` each have
``snapshot_state() -> dict`` (host arrays only) and
``restore_state(state)``, and the engine composes them.

``staleness_bound`` is measured in applied mutation batches and bounds how
far the published graph version that serving reads may lag the freshest
applied state; 0 (the default) serves the live graph and keeps the
pipeline bitwise with the synchronous path, > 0 turns on the concurrent
maintenance plane (``serve/maintenance.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable


@dataclasses.dataclass(frozen=True)
class MaintenanceConfig:
    """Knobs for index/graph upkeep and the concurrent maintenance plane.

    staleness_bound: max batches the published graph version serving
        reads may lag the freshest applied state; 0 = serve the live graph.
    compact: auto-compact a sharded slab before a wrapping append.
    headroom: slab sizing slack multiplier at build time.
    soar: SOAR secondary-copy weight; negative disables the second copy.
    resplit: imbalance ratio that arms automatic owner-salt re-splits;
        0 = manual only.
    resplit_metric: skew signal for re-splits, "occupancy" or "load".
    repair_per_tick: graph repair re-queries drained per maintenance tick.
    """

    staleness_bound: int = 0
    compact: bool = True
    headroom: float = 8.0
    soar: float = 1.0
    resplit: float = 0.0
    resplit_metric: str = "occupancy"
    repair_per_tick: int = 256

    def __post_init__(self):
        if self.staleness_bound < 0:
            raise ValueError(
                f"staleness_bound={self.staleness_bound} must be >= 0")
        if self.resplit_metric not in ("occupancy", "load"):
            raise ValueError(
                f"resplit_metric={self.resplit_metric!r} must be "
                "'occupancy' or 'load' (by-occupancy slab fill vs. "
                "accumulated per-shard query load)")


@runtime_checkable
class SnapshotStateful(Protocol):
    """Snapshot/recover contract composed by ``GusEngine``.

    ``snapshot_state()`` returns a plain dict (host arrays / scalars
    only) that ``restore_state`` accepts on a freshly-built instance of
    the same configuration. Implementors: ``FeatureStore``, the ANN
    backends, ``DynamicGraphStore``, ``MultiModalStore``, ``IdfCounts``
    and ``DynamicGUS`` (which composes them).
    """

    def snapshot_state(self) -> dict: ...

    def restore_state(self, state: dict) -> None: ...
