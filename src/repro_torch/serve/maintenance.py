"""Concurrent maintenance plane: off-path graph ticks behind snapshots
(port of ``repro/serve/maintenance.py``).

With ``MaintenanceConfig.staleness_bound == 0`` the pipeline reproduces
the synchronous schedule bit-for-bit: a maintained graph (or an armed
auto-resplit policy) pins the fuse window to 1 and every batch's graph
tick runs inline in the hand-off. The bound==0 regime never constructs
deferred work — this module is inert.

With ``staleness_bound = B > 0`` the contract relaxes from bitwise
identity to *bounded staleness*: queries read the last **published
snapshot** (an immutable :class:`~repro_torch.graph.store.GraphView`;
the sharded backend's ``IndexVersion``), which may lag the
applied mutation stream by at most ``B`` batches. The pipeline then
fuses windows even with a graph configured, and each window's graph
work — the merge-and-re-top-k tick, back-edge purges, and the batched
repair drain — is handed to this :class:`MaintenanceWorker` instead of
running on the serving thread.

The worker is *cooperative*, not a thread: deterministic and
replay-friendly. The pipeline calls :meth:`settle` after every hand-off
(drains just enough deferred windows to re-establish the bound) and
:meth:`drain` at ``flush()`` (the full barrier — after it, the published
views are exactly the synchronous end state, which is what the
quiescence tests pin). Each tick builds the successor graph state
fully, then swaps it in with one atomic ``publish`` — a version bump
plus a reference assignment — so queries never observe a half-built
version.

Index maintenance (auto-resplit and the slab snapshot) runs **only at
drain boundaries**: the routing salt a re-split bumps is baked into
staged PQ encodings, so it must never land between a window's encode
and its apply. Only the sharded backend carries the hooks
(``auto_resplit_on`` / ``auto_resplit``, ``publish``);
``_index_maintenance`` finds them by name, so brute and scann skip it.

On the card a tick's graph work runs on the same stream as the writes it
follows; its answer reaches the host inside the probe query, so a tick's
``maintenance_tick_ms`` covers its device work.
"""
from __future__ import annotations

import time
from collections import deque

from repro_torch.core.gus import DynamicGUS, StagedMutation
from repro_torch.obs import Telemetry


class MaintenanceWorker:
    """Deferred graph/index maintenance over a ``DynamicGUS`` (see
    module doc). Constructed unconditionally by ``MutationPipeline`` so
    its instruments register eagerly; it only ever holds work when the
    staleness bound is positive."""

    def __init__(self, gus: DynamicGUS,
                 telemetry: Telemetry | None = None,
                 repair_per_tick: int | None = None):
        self.gus = gus
        self.obs = telemetry if telemetry is not None else Telemetry()
        self.bound = gus.maintenance.staleness_bound
        self.repair_per_tick = repair_per_tick
        # FIFO of (staged_window, seq_after_window): graph work deferred
        # by pipeline hand-offs, applied oldest-first by tick()
        self._deferred: deque[tuple[StagedMutation, int]] = deque()
        # seq of the last published graph view (the staleness ledger's
        # read side; gus.seq_applied is the write side)
        self.published_seq = gus.seq_applied
        self.ticks = 0
        self.repaired = 0
        self.swaps = 0
        self.offpath_s = 0.0          # maintenance time kept off-path
        reg = self.obs.registry
        self._c_ticks = reg.counter(
            "maintenance_ticks_total", "deferred graph ticks applied")
        self._c_deferred = reg.counter(
            "maintenance_deferred_batches_total",
            "mutation batches whose graph work was deferred off-path")
        self._c_repaired = reg.counter(
            "maintenance_repaired_total",
            "graph repair re-queries drained off-path")
        self._c_swaps = reg.counter(
            "maintenance_swaps_total", "snapshot versions published")
        self._g_lag = reg.gauge(
            "maintenance_lag",
            "applied batches not yet in the published snapshot")
        self._h_tick = reg.histogram(
            "maintenance_tick_ms", "one deferred tick (graph apply + "
            "repair drain + publish)")

    # ------------------------------------------------------------- state

    def lag(self) -> int:
        """Applied mutation batches the published view has not absorbed —
        the quantity ``staleness_bound`` bounds."""
        return self.gus.seq_applied - self.published_seq

    def pending(self) -> int:
        """Deferred windows not yet ticked."""
        return len(self._deferred)

    # ------------------------------------------------------------- plane

    def defer(self, staged: StagedMutation, seq: int,
              n_batches: int) -> None:
        """Queue one applied window's graph work; ``seq`` is
        ``gus.seq_applied`` after the window, ``n_batches`` the fused
        batch count (the staleness it adds)."""
        self._deferred.append((staged, seq))
        self._c_deferred.inc(n_batches)
        self._g_lag.set(self.lag())

    def tick(self) -> int:
        """Apply the oldest deferred window's graph work and publish the
        successor snapshot. Returns repair re-queries drained (0 when
        nothing is deferred)."""
        if not self._deferred:
            return 0
        staged, seq = self._deferred.popleft()
        t0 = time.perf_counter()
        with self.obs.tracer.span("maintenance_tick", seq=seq):
            with self.gus.graph_timer:
                self.gus.graph_apply(staged, reuse_emb=True)
                repaired = self.gus.flush_graph_repair(self.repair_per_tick)
            view = self.gus.graph.publish(seq=seq)
        dt = time.perf_counter() - t0
        self.offpath_s += dt
        self.published_seq = seq
        self.ticks += 1
        self.repaired += repaired
        self.swaps += 1
        self._c_ticks.inc()
        self._c_repaired.inc(repaired)
        self._c_swaps.inc()
        self._g_lag.set(self.lag())
        self._h_tick.record(dt)
        self.obs.events.emit("maintenance_tick", seq=seq,
                             repaired=repaired, lag=self.lag())
        self.obs.events.emit("snapshot_swap", plane="graph",
                             version=view.version, seq=seq)
        return repaired

    def settle(self) -> None:
        """Re-establish the staleness invariant: tick deferred windows
        oldest-first until the published view is within ``bound`` of the
        applied stream. Called after every hand-off."""
        while self._deferred and self.lag() > self.bound:
            self.tick()

    def drain(self) -> None:
        """Full barrier: tick every deferred window, then run the
        index-side maintenance that is only safe with nothing staged or
        in flight (auto-resplit — its salt is baked into staged encode
        routing — and the index snapshot). After ``drain`` the published
        views equal the synchronous end state."""
        while self._deferred:
            self.tick()
        if self.gus.graph is not None and self.lag() > 0:
            # deletes advance seq without deferring graph work; publish
            # the catch-up view so quiescent lag reads 0
            view = self.gus.graph.publish(seq=self.gus.seq_applied)
            self.published_seq = self.gus.seq_applied
            self.swaps += 1
            self._c_swaps.inc()
            self._g_lag.set(0)
            self.obs.events.emit("snapshot_swap", plane="graph",
                                 version=view.version,
                                 seq=self.published_seq)
        self._index_maintenance()

    def _index_maintenance(self) -> None:
        index = self.gus.index
        if getattr(index, "auto_resplit_on", False):
            t0 = time.perf_counter()
            index.auto_resplit()
            self.offpath_s += time.perf_counter() - t0
        if hasattr(index, "publish"):
            ver = index.publish(seq=self.gus.seq_applied)
            self.swaps += 1
            self._c_swaps.inc()
            self.obs.events.emit("snapshot_swap", plane="index",
                                 version=ver.version,
                                 seq=self.gus.seq_applied)

    def describe(self) -> dict:
        return {
            "bound": self.bound,
            "ticks": self.ticks,
            "repaired": self.repaired,
            "swaps": self.swaps,
            "deferred": len(self._deferred),
            "lag": self.lag(),
            "offpath_ms": self.offpath_s * 1e3,
        }
