"""Async double-buffered mutation pipeline with batched graph repair
(port of ``repro/serve/pipeline.py``).

The paper's headline claim is tens-of-milliseconds mutation latency
*while serving*: the write path must not serialize host work behind
device work. The synchronous ``DynamicGUS.mutate`` alternates strictly —
host routing/encoding, then the device append, then graph maintenance —
so on every batch one side idles while the other runs, and every RPC
batch pays the full fixed dispatch cost of the encode + append programs.

``MutationPipeline`` double-buffers *windows* of mutate batches:

  stage A (host)    — ``encode_mutation`` for window *w+1*: feature
                      normalization, embedding, backend routing / PQ
                      encoding, issued once over the fused window's rows.
                      Pure w.r.t. engine state.
  stage B (device)  — the append/tombstone for window *w*, issued at the
                      previous hand-off.

``submit(batch)`` accumulates batches into the staging window; when the
window closes (``PipelineConfig.window`` batches, a delete, an id staged
twice, or ``flush``), the fused window is encoded (stage A) and the
previous window's hand-off runs. The barrier lives only inside that
hand-off: ``finish_mutation`` waits on the CUDA event the index recorded
after window *w*'s slab writes (``StagedMutation.pending``), not on the
whole device, so work queued after that event (a later window's encode,
a query issued meanwhile) is not waited for. Work queued before it is:
every engine on one card issues on the same current stream, so a
member's hand-off still waits for whatever other engines queued ahead of
its event.
Fusing amortizes the per-launch overhead that dominates small-batch
mutation streams — the RPC batch size is unchanged; only the device-side
work sees the fused rows.

Stream order on the card: every engine issues on the current CUDA stream,
so the order of device work is the order of issue. Window *w+1*'s encode
is issued before window *w*'s hand-off, and scann's ``begin_upsert``
copies *w*'s partition routing to the host, so that copy also waits for
*w+1*'s encode kernels. Results are the same bit for bit; the overlap of
host and device that JAX's asynchronous dispatch gives the reference is
smaller here (``PERF.md`` measures the encode and hand-off spans).

**Exactness — the window-closing rules.** A fused window is restricted
to upsert-only batches with pairwise-disjoint ids (every operation in
the write path — hashing, IDF lookup, CountSketch, partition argmin, PQ
encode, slab scatter — is row-independent, and free-list pops happen in
the same order), so fused execution is *bit-identical* to applying the
batches one at a time. The first three rules hold at every staleness
bound, because they name regimes where fused *application* itself stops
being exact:

* **deletes** close the window and apply alone, preserving order;
* **duplicate ids** (an id staged or in flight twice) close it — fused
  last-write-wins would drop the earlier write's slot churn;
* **updates of live ids on scann** close it
  (``ScannIndex.FUSED_UPDATES_EXACT = False``): its update path
  re-routes free-list slots, which shifts slab layout and breaks
  PQ-score *ties* at the shortlist cut.

**The fuse-window pins — bound == 0 (the default, bitwise-identical
contract).** Three more rules exist only to reproduce the synchronous
*maintenance schedule* exactly, and they are what historically capped
pipelined throughput (the two sharded pins read the backend's
``maintenance_pressure`` / ``auto_resplit_on`` by name; brute and scann
have neither):

* **a maintained graph pins the window to 1**: the graph tick for batch
  *i* must observe the index exactly as of batch *i*, the same state the
  synchronous path sees;
* **compaction boundary (sharded)**: while the backend reports
  ``maintenance_pressure`` (an append could wrap a slab ring given the
  staged + in-flight rows), the window pins to 1 so auto-compaction
  fires on exactly the synchronous per-batch schedule;
* **armed auto-resplit (sharded)** pins the window to 1: the skew
  trigger must evaluate once per batch with every prior batch applied,
  and the salt it may bump is baked into staged routing — so the
  pipeline hands off the previous window and runs ``auto_resplit()``
  before each window's encode.

One pin holds at **every** bound: a configured multi-modal reload
cadence (``MultiModalConfig.reload_every > 0``) pins the window to 1.
Routing-table reloads fire when ``seq_applied`` crosses cadence
multiples — right after the hand-off's seq bump, before any graph work
(the synchronous ``mutate`` ordering) — and later batches sketch and
route against the reloaded tables, so a fused window would skip reload
points the synchronous path hits.

**The concurrent maintenance plane — bound > 0.** With
``MaintenanceConfig.staleness_bound = B > 0`` the contract relaxes from
bitwise identity to *bounded staleness* and all three pins lift:

* windows fuse up to ``min(window, B)`` batches even with a maintained
  graph. The hand-off applies the fused window to the index and store,
  then **defers** the graph tick — the fused merge-and-re-top-k probe,
  back-edge purges, and the batched repair drain — to the cooperative
  ``serve.maintenance.MaintenanceWorker``, which builds the successor
  graph state and publishes it as an immutable versioned snapshot
  (``GraphView``) with one atomic swap. Queries read the last published
  view, which lags the applied mutation stream by **at most B batches**
  (``worker.settle()`` runs after every hand-off to re-establish the
  invariant);
* compaction no longer closes windows: it stays inside ``begin_upsert``,
  where it is safe at any fuse width (window *w-1* is always fully
  finished before window *w*'s apply) — it is simply no longer required
  to land on the per-batch schedule;
* auto-resplit runs only at **drain boundaries** (``flush``), when
  nothing is staged or in flight — the salt it bumps is baked into
  staged encode routing, so it must never land between a window's
  encode and its apply.

Graph repair rides the tick cadence: rows left under-full by purges or
evictions accumulate in ``DynamicGraphStore``'s coalesced, deduped
repair queue and are re-queried as **one batched**
``_index_neighbors_of_ids`` call per tick, capped at
``repair_per_tick`` — never as per-mutation one-offs. The forward probe
for the upserted points reuses the staged embeddings
(``graph_apply(reuse_emb=True)``).

Equivalence contract: with ``staleness_bound == 0`` (the default), a
``submit`` per batch plus a final ``flush()`` produces **bit-identical**
index rows, graph adjacency, and CC labels to calling
``DynamicGUS.mutate`` per batch — the pipeline only moves work in time
and fuses device dispatches, never changes per-row results. With
``staleness_bound = B > 0`` the guarantee is: reads are answered from a
published snapshot at most ``B`` applied batches stale, and ``flush()``
drains the plane so the published views equal the synchronous end state
(connected components are exact at quiescence). ``flush()`` is the
explicit barrier either way: call it before snapshots, recovery,
rebuilds, or any read that must observe every submitted batch
(``GusEngine`` does).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.gus import DynamicGUS, StagedMutation
from repro_torch.core.types import MutationBatch, MUTATION_DELETE
from repro_torch.obs import Telemetry
from repro_torch.serve.maintenance import MaintenanceWorker
from repro_torch.utils.timing import Timer


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # max upsert-only batches fused per window (1 = strict per-batch
    # double buffering; forced to 1 while a maintained graph is on and
    # the staleness bound is 0)
    window: int = 8
    # repair re-queries drained per tick; None = the graph's
    # ``MaintenanceConfig.repair_per_tick``, which keeps the pipeline
    # bit-identical to the synchronous path (the equivalence tests pin
    # this)
    repair_per_tick: int | None = None


def fuse_batches(batches: list) -> MutationBatch:
    """Concatenate window batches into one MutationBatch (rows in submit
    order; callers guarantee upsert-only and disjoint ids)."""
    if len(batches) == 1:
        return batches[0]
    return MutationBatch(
        kinds=np.concatenate([np.asarray(b.kinds) for b in batches]),
        ids=np.concatenate([np.asarray(b.ids) for b in batches]),
        features={k: np.concatenate(
            [np.asarray(b.features[k]) for b in batches])
            for k in batches[0].features})


class MutationPipeline:
    """Double-buffered write path over a ``DynamicGUS`` (see module doc)."""

    def __init__(self, gus: DynamicGUS,
                 cfg: PipelineConfig = PipelineConfig(),
                 telemetry: Telemetry | None = None):
        self.gus = gus
        self.cfg = cfg
        # plane-wide instruments (the engine shares one Telemetry across
        # its per-member pipelines, so these aggregate the whole write
        # path; the per-pipeline describe() view keeps its own counts)
        self.obs = telemetry if telemetry is not None else Telemetry()
        reg = self.obs.registry
        self._c_submitted = reg.counter(
            "pipeline_submitted_total", "mutation points acknowledged")
        self._c_windows = reg.counter(
            "pipeline_windows_total", "fused windows encoded")
        self._c_ticks = reg.counter(
            "pipeline_ticks_total", "completed hand-offs")
        self._c_repaired = reg.counter(
            "pipeline_repaired_total", "graph repair re-queries drained")
        self._h_encode = reg.histogram(
            "pipeline_encode_ms", "stage-A fused encode dispatch time")
        self._h_handoff = reg.histogram(
            "pipeline_handoff_ms", "stage-B hand-off (apply + barrier)")
        # staleness_bound == 0 keeps the bitwise-identical contract and
        # its fuse-window pins; > 0 activates the maintenance plane
        self.bound = gus.maintenance.staleness_bound
        # the worker is constructed unconditionally (its instruments
        # must register eagerly for the metrics catalog) but only holds
        # deferred work when the bound is positive
        self.worker = MaintenanceWorker(
            gus, telemetry=self.obs, repair_per_tick=cfg.repair_per_tick)
        self._queue: list[MutationBatch] = []     # accumulating window
        self._queue_ids: set = set()              # upserted ids staged
        self._inflight: StagedMutation | None = None
        self._inflight_ids: set = set()           # upserted ids in flight
        # backends whose update path re-routes free-list slots (scann)
        # cannot fuse updates of live ids bit-exactly — fall back to a
        # window boundary before them
        self._fused_updates_exact = getattr(
            gus.index, "FUSED_UPDATES_EXACT", True)
        # backends with a slab lifecycle (sharded) report wrap pressure;
        # under the bitwise contract the window closes while it holds
        # (the compaction boundary); under the plane, compaction inside
        # begin_upsert is safe at any fuse width
        self._pressure = (getattr(gus.index, "maintenance_pressure", None)
                          if self.bound == 0 else None)
        # bitwise contract only: an armed auto-resplit policy pins the
        # window to 1 and runs on the synchronous schedule (previous
        # hand-off, then the trigger, then this window's encode). Under
        # the plane the worker re-splits at drain boundaries instead.
        self._maintain = gus.index \
            if (self.bound == 0
                and getattr(gus.index, "auto_resplit_on", False)) else None
        # a multi-modal reload cadence pins the window to 1 at every
        # bound: table reloads fire on seq_applied multiples, and later
        # batches embed/sketch against the reloaded tables, so the
        # pipelined schedule must hit the same seq points as the
        # synchronous path (n_batches == 1 per hand-off)
        self._mm_reload = (gus.multimodal is not None
                           and gus.multimodal.cfg.reload_every > 0)
        self._queued_rows = 0         # upsert rows staged in the window
        self._inflight_rows = 0       # upsert rows in the in-flight window
        self._inflight_batches = 0    # batches fused into the in-flight window
        self.submitted = 0            # points acknowledged
        self.windows = 0              # fused windows encoded
        self.ticks = 0                # completed hand-offs
        self.repaired = 0             # repair re-queries drained
        self.encode_timer = Timer("pipeline_encode")
        self.handoff_timer = Timer("pipeline_handoff")

    @property
    def in_flight(self) -> bool:
        return self._inflight is not None or bool(self._queue)

    def backlog(self) -> int:
        """Batches submitted but not yet through a hand-off (staged window
        + the in-flight window) — the front-end's backpressure signal."""
        return len(self._queue) + (self._inflight is not None)

    def window_size(self) -> int:
        """Effective fuse window. Bitwise contract (bound 0): a
        maintained graph pins it to 1 so the per-batch graph tick sees
        exactly the synchronous index states, and an armed auto-resplit
        policy pins it too. Under the plane (bound > 0) a maintained
        graph fuses up to ``min(window, bound)`` batches — each window
        is one unit of published staleness. A multi-modal reload cadence
        pins the window to 1 at *every* bound (see __init__)."""
        if self._mm_reload:
            return 1
        if self.bound > 0:
            if self.gus.graph is not None:
                return max(1, min(self.cfg.window, self.bound))
            return max(1, self.cfg.window)
        if self.gus.graph is not None or self._maintain is not None:
            return 1
        return max(1, self.cfg.window)

    def submit(self, batch: MutationBatch) -> int:
        """Stage the batch. Returns the number of points acknowledged
        (they become query-visible at the next hand-off — ``flush()``
        forces it)."""
        kinds = np.asarray(batch.kinds)
        ids = np.asarray(batch.ids)
        has_del = bool((kinds == MUTATION_DELETE).any())
        up_ids = set(ids[kinds != MUTATION_DELETE].tolist())
        updates_live = (not self._fused_updates_exact) and any(
            pid in self.gus.store or pid in self._inflight_ids
            for pid in up_ids)
        # compaction boundary (bitwise contract only): while an append
        # could wrap a slab (counting staged + in-flight + incoming
        # rows), windows pin to 1 so the backend's auto-compaction fires
        # on exactly the per-batch schedule the synchronous path runs
        pressure = self._pressure is not None and self._pressure(
            self._queued_rows + self._inflight_rows + len(up_ids))
        # window boundaries keep fused windows upsert-only with disjoint
        # ids (and, for layout-sensitive backends, free of updates) — the
        # regime where fused == sequential, bitwise
        if self._queue and (has_del or updates_live or pressure
                            or len(self._queue) >= self.window_size()
                            or (up_ids & self._queue_ids)):
            self._close_window(
                "delete" if has_del
                else "updates_live" if updates_live
                else "pressure" if pressure
                else "window_full" if len(self._queue) >= self.window_size()
                else "duplicate_ids")
        self._queue.append(batch)
        self._queue_ids |= up_ids
        self._queued_rows += len(up_ids)
        self.submitted += int(ids.size)
        self._c_submitted.inc(int(ids.size))
        if has_del or pressure:       # deletes / wrap risk apply alone
            self._close_window("delete" if has_del else "pressure")
        return int(ids.size)

    def flush(self) -> None:
        """Barrier: encode + apply everything staged, complete the
        in-flight window, and drain the maintenance plane (deferred
        graph ticks, drain-boundary re-splits, snapshot publication).
        After ``flush`` the engine state — and every published view —
        is exactly what the synchronous path would have produced."""
        self._close_window()
        self._handoff()
        if self.bound > 0:
            self.worker.drain()

    def _close_window(self, reason: str = "flush") -> None:
        """Stage A for the accumulated window: fuse, encode (dispatch
        only), then hand off the previous window and park this one as
        in-flight. ``reason`` names the window-closing rule that fired
        (the ``window_close`` structured event)."""
        if not self._queue:
            return
        self.obs.events.emit("window_close", reason=reason,
                             batches=len(self._queue),
                             rows=self._queued_rows)
        if self._maintain is not None:
            # synchronous-schedule re-split: apply the previous window,
            # then let the policy fire before this window's encode
            self._handoff()
            self._maintain.auto_resplit()
        fused = fuse_batches(self._queue)
        queue_ids = self._queue_ids
        queue_rows = self._queued_rows
        queue_batches = len(self._queue)
        self._queue = []
        self._queue_ids = set()
        self._queued_rows = 0
        with self.obs.tracer.span("encode", batches=len(fused.ids)):
            t0 = time.perf_counter()
            staged = self.gus.encode_mutation(fused)
            t_encode = time.perf_counter() - t0
        self.encode_timer.record(t_encode)
        self._h_encode.record(t_encode)
        # mutation latency in pipelined mode = the stage-A dispatch; the
        # window's apply/barrier overlaps later submits (handoff timer)
        self.gus.mutation_timer.record(t_encode)
        self.windows += 1
        self._c_windows.inc()
        self._handoff()
        self._inflight = staged
        self._inflight_ids = queue_ids
        self._inflight_rows = queue_rows
        self._inflight_batches = queue_batches

    def _handoff(self) -> None:
        staged = self._inflight
        if staged is None:
            return
        n_batches = self._inflight_batches
        self._inflight = None
        self._inflight_ids = set()
        self._inflight_rows = 0
        self._inflight_batches = 0
        with self.obs.tracer.span("handoff"), self.handoff_timer, \
                self._h_handoff:
            # stage B: the slab writes of the window encoded at the last
            # close, then the barrier on their own CUDA event
            self.gus.apply_mutation(staged)
            self.gus.finish_mutation(staged)
            self.gus.seq_applied += n_batches
            # multi-modal routing-table reload fires on the same
            # seq_applied schedule as the synchronous path (the reload
            # cadence pins the window to 1), and before any graph work —
            # matching DynamicGUS.mutate's ordering exactly
            self.gus.maybe_reload_multimodal()
            if self.gus.graph is not None:
                if self.bound > 0:
                    # plane: the graph tick and repair drain come off
                    # the hand-off path; settle() below re-establishes
                    # the staleness invariant
                    self.worker.defer(staged, self.gus.seq_applied,
                                      n_batches)
                else:
                    with self.gus.graph_timer:
                        self.gus.graph_apply(staged, reuse_emb=True)
                        repaired = self.gus.flush_graph_repair(
                            self.cfg.repair_per_tick)
                        self.repaired += repaired
                        self._c_repaired.inc(repaired)
        self.ticks += 1
        self._c_ticks.inc()
        if self.bound > 0:
            self.worker.settle()

    def describe(self) -> dict:
        """Structured pipeline state (counters, timer summaries, and the
        maintenance plane's ledger)."""
        out = {
            "submitted": self.submitted,
            "windows": self.windows,
            "ticks": self.ticks,
            "staged_batches": len(self._queue),
            "in_flight": self.in_flight,
            "repaired": self.repaired,
            "encode": self.encode_timer.summary(),
            "handoff": self.handoff_timer.summary(),
            "maintenance": self.worker.describe(),
        }
        if self.gus.graph is not None:
            out["repair_backlog"] = self.gus.graph.repair_backlog()
        return out
