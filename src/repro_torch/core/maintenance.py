"""Maintenance knobs of the maintained graph (port of
``repro/core/maintenance.py``): ``MaintenanceConfig``, carried by
``GraphConfig.maintenance``.

The port keeps the two knobs its graph path reads. The reference's
sharded-backend knobs (``compact``, ``headroom``, ``soar``, ``resplit``,
``resplit_metric``), its ``GusConfig.maintenance`` override and its
``SnapshotStateful`` protocol wait for the sharded backend and the
engine's snapshot/restore; its one-release deprecation shims
(``resolve_legacy``, ``GraphConfig.repair_per_batch``) exist only for old
in-repo spellings and are not ported.

``staleness_bound`` is measured in applied mutation batches and bounds how
far the published graph version that serving reads may lag the freshest
applied state; 0 (the default) serves the live graph.
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
