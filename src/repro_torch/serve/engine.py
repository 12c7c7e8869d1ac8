"""GUS serving engine: replica groups, hedging, fail-over, fault recovery
(port of ``repro/serve/engine.py``).

Wraps ``DynamicGUS`` with the operational layer a production deployment
needs (paper §3.1 runs at "hundreds of thousands of RPCs per second"):

* **replica groups** — the engine fans every mutation batch out to a
  group of replicas (``serve.replica``). Replicas are full ``DynamicGUS``
  instances with device tensors of their own (on one card they share it
  and its current stream; each index's write barrier is its own batch's
  CUDA event, which spares the work queued after it but not the other
  members' work queued before it). Per-replica ``applied_seq`` tracks
  freshness against the engine's committed mutation sequence;
* **straggler hedging + fail-over** — if the primary's reply lags past
  the hedge deadline, the query reissues against the next *eligible*
  replica (round-robin; dead, partitioned, and stale members are
  skipped). A dead primary fails over entirely; when nobody can serve,
  the engine raises ``ServingUnavailableError`` — an explicit error, so
  callers (the request front-end) answer the request rather than lose
  it;
* **fault injection** — every health/latency decision consults an
  optional ``serve.faults.FaultInjector``: scripted kill / slow /
  partition faults steer routing deterministically (synthetic straggler
  latency is *added* to measured time, never slept). Revived or healed
  members rejoin through **freshness catch-up**: the engine replays the
  mutation-log suffix they missed (or re-bootstraps from the snapshot
  when the log no longer reaches back far enough) before they serve
  again;
* **freshness accounting** — per-mutation timestamps measure visibility
  lag (the paper's "data freshness within seconds at p99"); ``serving``
  records per-request effective latency (hedges and injected straggler
  time included) for the p95/p99-under-load metrics;
* **mutation log + snapshot restart** — every submitted batch is
  appended to a host-side log; ``recover()`` replays the suffix after a
  crash/restart. Snapshots are the *composed* dict of
  ``DynamicGUS.snapshot_state``, host arrays only: the feature store's
  corpus, the index's routing state (empty for brute and scann), the
  maintained graph's arrays and the multi-modal plane. ``describe()``
  surfaces per-replica health and the latency summaries.

Staleness contract: a query is answered only by members whose
``applied_seq`` is within ``EngineConfig.staleness_batches`` of the
committed sequence (default 0 — exact freshness: every answer observes
every submitted mutation, because ``query()`` flushes the async write
path and catches lagging members up first).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.core.gus import DynamicGUS
from repro_torch.core.types import MutationBatch, NeighborResult
from repro_torch.obs import Telemetry
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.pipeline import MutationPipeline, PipelineConfig
from repro_torch.serve.replica import Replica, ReplicaSet
from repro_torch.utils import pow2_pad
from repro_torch.utils.timing import percentiles


class ServingUnavailableError(RuntimeError):
    """No eligible member (primary or replica) can answer a query."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    query_batch: int = 64         # padded query batch size
    hedge_ms: float = 50.0        # straggler hedge deadline
    snapshot_every: int = 50      # mutation batches between snapshots
    # async write path: double-buffer mutate batches through
    # serve.pipeline.MutationPipeline (final state identical to the
    # synchronous path; queries/snapshots flush first)
    pipeline: bool = False
    repair_per_tick: int | None = None   # None = graph's repair_per_batch
    # documented staleness bound: a member may answer while within this
    # many committed batches of the engine's sequence (0 = exact)
    staleness_batches: int = 0


class GusEngine:
    def __init__(self, gus: DynamicGUS, cfg: EngineConfig = EngineConfig(),
                 replicas: Sequence[DynamicGUS] = (),
                 faults: FaultInjector | None = None,
                 telemetry: Telemetry | None = None):
        self.gus = gus
        self.cfg = cfg
        self.faults = faults or FaultInjector()
        # one telemetry plane per engine, shared with the front-end, the
        # mutation pipelines, the multi-modal store and the sharded index
        # so every instrument exports through a single registry
        self.obs = telemetry if telemetry is not None else Telemetry()
        reg = self.obs.registry
        self._c_queries = reg.counter(
            "engine_queries_total", "queries answered by the engine")
        self._c_hedges = reg.counter(
            "engine_hedges_total", "queries reissued past the hedge deadline")
        self._c_failovers = reg.counter(
            "engine_failovers_total", "queries failed over off the primary")
        self._c_unavailable = reg.counter(
            "engine_unavailable_total", "queries no eligible member could serve")
        self._c_batches = reg.counter(
            "engine_mutation_batches_total", "mutation batches committed")
        self._c_snapshots = reg.counter(
            "engine_snapshots_total", "snapshots taken")
        self._c_catchups = reg.counter(
            "engine_catchups_total", "freshness catch-ups completed")
        self._c_catchup_batches = reg.counter(
            "engine_catchup_batches_total", "log batches replayed in catch-up")
        self._g_seq = reg.gauge(
            "engine_seq", "committed mutation-batch sequence")
        # per-request effective latency (hedges + injected straggler ms)
        self.serving = reg.histogram(
            "engine_serving_ms", "per-request effective serving latency")
        self.freshness = reg.histogram(
            "engine_freshness_ms", "mutation submit-to-visible latency")
        self.service = reg.histogram(
            "engine_service_ms", "first eligible member's answer time")
        self.hedge_wait = reg.histogram(
            "engine_hedge_wait_ms", "extra wait on hedged reissues")
        self.primary = Replica("primary", gus, key=FaultInjector.PRIMARY)
        self.replica_set = ReplicaSet(
            [Replica(f"replica:{i}", g, key=i)
             for i, g in enumerate(replicas)],
            staleness_batches=cfg.staleness_batches)
        self.pipelines: list[MutationPipeline] = []
        if cfg.pipeline:
            pcfg = PipelineConfig(repair_per_tick=cfg.repair_per_tick)
            self.pipelines = [MutationPipeline(g, pcfg, telemetry=self.obs)
                              for g in (gus, *replicas)]
        bind = getattr(gus.index, "bind_telemetry", None)
        if callable(bind):
            bind(self.obs)           # the sharded backend's instruments
        if gus.multimodal is not None:
            gus.multimodal.bind_telemetry(self.obs)
        self.mutation_log: list[MutationBatch] = []
        self.log_since_snapshot = 0
        self.snapshot_state: dict | None = None
        self.seq = 0                 # committed mutation-batch sequence
        self.seq_base = 0            # sequence at the log's first entry
        # health transitions observed so far (name -> (alive, partitioned));
        # _sync_health emits replica_down/up/partitioned/healed on change
        self._known_health = {m.name: (True, False)
                              for m, _ in self._members()}

    # read-only views over the registry counters: the attribute API the
    # tests and benchmarks pin (engine.hedged etc.) stays intact
    @property
    def queries(self) -> int:
        return self._c_queries.value

    @property
    def hedged(self) -> int:
        return self._c_hedges.value

    @property
    def failovers(self) -> int:
        return self._c_failovers.value

    # ----------------------------------------------------- replica plumbing

    @property
    def replicas(self) -> list[DynamicGUS]:
        """The replica GUS instances (kept for API compatibility)."""
        return [r.gus for r in self.replica_set]

    @property
    def replica_hedges(self) -> list[int]:
        return [r.hedges for r in self.replica_set]

    def _members(self):
        """(member, pipeline-or-None) over primary + replicas, aligned
        with the pipelines list."""
        out = []
        for i, member in enumerate((self.primary, *self.replica_set)):
            pipe = self.pipelines[i] if self.pipelines else None
            out.append((member, pipe))
        return out

    def _sync_health(self) -> None:
        """Mirror the fault injector's scripted state into the members'
        health flags (the injector is the script; Replica is the record).
        Transitions emit structured events (``replica_down`` / ``_up`` /
        ``_partitioned`` / ``_healed``) so chaos tests can assert why."""
        for member, _ in self._members():
            alive = not self.faults.killed(member.key)
            part = self.faults.partitioned(member.key)
            prev_alive, prev_part = self._known_health.get(
                member.name, (True, False))
            if alive != prev_alive:
                self.obs.events.emit(
                    "replica_up" if alive else "replica_down",
                    member=member.name, seq=self.seq)
            if part != prev_part:
                self.obs.events.emit(
                    "replica_partitioned" if part else "replica_healed",
                    member=member.name, seq=self.seq)
            self._known_health[member.name] = (alive, part)
            member.alive = alive
            member.partitioned = part

    def _eligible(self, member: Replica) -> bool:
        return self.replica_set.eligible(member, self.seq)

    # ------------------------------------------------------------ mutations

    def submit_mutations(self, batch: MutationBatch) -> None:
        """Commit the batch: append to the log, fan out to every member
        that can currently receive it (dead/partitioned members miss it
        and fall behind — catch-up replays the suffix when they rejoin)."""
        self._sync_health()
        t0 = time.perf_counter()
        self.seq += 1
        self._c_batches.inc()
        self._g_seq.set(self.seq)
        for member, pipe in self._members():
            if not member.alive or member.partitioned:
                continue                      # falls behind; catch_up later
            if pipe is not None:
                pipe.submit(batch)
            else:
                member.gus.mutate(batch)
            member.applied_seq = self.seq
        self.mutation_log.append(batch)
        self.log_since_snapshot += 1
        # visibility lag: synchronous mutations are visible when mutate()
        # returns; pipelined ones when the next hand-off completes (the
        # engine flushes before any read, so this is the submit latency)
        self.freshness.record(time.perf_counter() - t0)
        if self.log_since_snapshot >= self.cfg.snapshot_every:
            self.snapshot()

    def flush(self) -> None:
        """Barrier for the async write path: after this, every submitted
        mutation is applied, graph-maintained, and query-visible."""
        for pipe in self.pipelines:
            pipe.flush()

    def mutation_backlog(self) -> int:
        """Batches admitted to the async write path but not yet through a
        hand-off (staged + in-flight). The front-end's backpressure
        signal; 0 on the synchronous path."""
        return sum(p.backlog() for p in self.pipelines)

    # ----------------------------------------------------- freshness rejoin

    def catch_up(self) -> int:
        """Replay the mutation-log suffix to every alive, un-partitioned
        member that lags the committed sequence (a revived/healed member's
        freshness rejoin). Members whose ``applied_seq`` predates the log
        (a snapshot truncated it) re-bootstrap from the snapshot first.
        Returns the number of batches replayed."""
        self._sync_health()
        replayed = 0
        for member in [self.primary, *self.replica_set]:
            if (not member.alive or member.partitioned
                    or member.applied_seq >= self.seq):
                continue
            if member.applied_seq < self.seq_base:
                # the log no longer reaches back: restore the snapshot
                # corpus, then replay the whole remaining log
                if self.snapshot_state is not None:
                    self._restore_gus(member.gus, self.snapshot_state)
                start = 0
            else:
                start = member.applied_seq - self.seq_base
            rebootstrapped = start == 0 and member.applied_seq < self.seq_base
            for mb in self.mutation_log[start:]:
                member.gus.mutate(mb)
                replayed += 1
            member.caught_up_batches += len(self.mutation_log) - start
            member.applied_seq = self.seq
            member.catchups += 1
            self._c_catchups.inc()
            self._c_catchup_batches.inc(len(self.mutation_log) - start)
            self.obs.events.emit(
                "catch_up", member=member.name, seq=self.seq,
                batches=len(self.mutation_log) - start,
                rebootstrapped=rebootstrapped)
        return replayed

    # -------------------------------------------------------------- queries

    def query(self, features: dict, k: int | None = None) -> NeighborResult:
        """Pad the query batch to a power of two, answer, unpad. Routing:
        primary if eligible, hedged against the next eligible replica past
        the deadline; fail-over when the primary cannot serve; explicit
        ``ServingUnavailableError`` when nobody can. Injected straggler
        latency is added to measured time (never slept) so hedging and
        the recorded serving latency respond to faults deterministically.

        The padded rows repeat the last row; every row is answered
        independently, so the real rows' answers do not depend on the
        padding.

        Tracing: when a caller (the front-end) has already activated a
        trace, the engine's spans attach to it; when called directly the
        engine owns a trace of its own for the sampled request."""
        self._c_queries.inc()
        tracer = self.obs.tracer
        owned = None
        if tracer.active is None:
            owned = tracer.trace("engine")
        ctx = (tracer.activate(owned) if owned is not None
               else contextlib.nullcontext())
        try:
            with ctx, tracer.span("engine_query"):
                with tracer.span("flush"):
                    self._sync_health()
                    self.flush()  # read-your-writes across the async path
                with tracer.span("catch_up"):
                    self.catch_up()   # lagging members rejoin first
                n = next(iter(features.values())).shape[0]
                padded = pow2_pad(n, self.cfg.query_batch)
                feats = {key: np.concatenate(
                    [v, np.repeat(v[-1:], padded - n, axis=0)], axis=0)
                    if padded > n else v for key, v in features.items()}
                with tracer.span("route"):
                    res, total_ms = self._route(feats, k)
                self.serving.observe(total_ms)
                return NeighborResult(
                    ids=res.ids[:n], weights=res.weights[:n],
                    distances=res.distances[:n])
        finally:
            if owned is not None:
                tracer.collect(owned)

    def _timed_answer(self, member: Replica, feats, k,
                      span: str = "answer_primary"):
        """One member's answer + its effective latency (measured plus any
        injected straggler ms; the injected part lands in the span's
        ``extra_ms`` meta, never in its wall-clock bounds). The answer is
        on the host when ``neighbors`` returns, so the measured part
        covers the device work."""
        t0 = time.perf_counter()
        res = member.gus.neighbors(feats, k)
        t1 = time.perf_counter()
        extra_ms = self.faults.extra_ms(member.key)
        self.obs.tracer.add_span(span, t0, t1, member=member.name,
                                 extra_ms=extra_ms)
        return res, (t1 - t0) * 1e3 + extra_ms

    def _route(self, feats, k):
        if self._eligible(self.primary):
            res, elapsed_ms = self._timed_answer(
                self.primary, feats, k, "answer_primary")
            self.service.observe(elapsed_ms)
            if elapsed_ms <= self.cfg.hedge_ms:
                self.primary.served += 1
                return res, elapsed_ms
            self._c_hedges.inc()
            self.obs.events.emit("hedge", primary_ms=elapsed_ms,
                                 seq=self.seq)
            replica = self.replica_set.pick(self.seq)
            if replica is not None:
                res, r_ms = self._timed_answer(
                    replica, feats, k, "answer_hedge")
                self.hedge_wait.observe(r_ms)
                replica.hedges += 1
                replica.served += 1
                return res, elapsed_ms + r_ms
            # no eligible replica fleet: reissue against the primary
            res, r_ms = self._timed_answer(
                self.primary, feats, k, "answer_hedge")
            self.hedge_wait.observe(r_ms)
            self.primary.served += 1
            return res, elapsed_ms + r_ms
        # primary down/stale: fail over to the replica group
        replica = self.replica_set.pick(self.seq)
        if replica is None:
            self._c_unavailable.inc()
            self.obs.events.emit("unavailable", seq=self.seq)
            raise ServingUnavailableError(
                "no eligible member: primary "
                f"{self.primary.describe()}, replicas "
                f"{self.replica_set.describe()}")
        res, r_ms = self._timed_answer(replica, feats, k, "answer_failover")
        self.service.observe(r_ms)
        replica.failovers += 1
        replica.served += 1
        self._c_failovers.inc()
        self.obs.events.emit("failover", member=replica.name, seq=self.seq)
        return res, r_ms

    # ------------------------------------------------------ fault tolerance

    def snapshot(self) -> None:
        """Snapshot = the composed dict from ``DynamicGUS.snapshot_state()``
        (host arrays only): the store's live corpus (the index is
        rebuildable state), the index's minimal routing state, the
        maintained graph arrays (rebuildable too, but restoring them skips
        the full-corpus re-query on recovery) and the multi-modal plane.
        Flushes the async write path first so the snapshot observes every
        submitted batch.
        Deferred while the primary cannot serve (dead/partitioned/stale):
        its state would miss committed batches."""
        self._sync_health()
        if not self._eligible(self.primary):
            return                      # retried after the next batch
        self.flush()
        self.snapshot_state = self.gus.snapshot_state()
        self.mutation_log.clear()
        self.seq_base = self.seq
        self.log_since_snapshot = 0
        self._c_snapshots.inc()
        self.obs.events.emit("snapshot", seq=self.seq,
                             rows=len(self.snapshot_state["store"]["ids"]))

    @staticmethod
    def _restore_gus(gus: DynamicGUS, snapshot_state: dict) -> None:
        """Load one GUS from a composed snapshot: each subsystem restores
        its own piece through ``restore_state`` (store cleared first — a
        stale member may hold rows the snapshot has already dropped; the
        index's routing state installs before the rebuild; graph arrays
        restore instead of recomputing where both sides have one)."""
        if not len(snapshot_state["store"]["ids"]):
            return
        gus.restore_state(snapshot_state)

    def recover(self, fresh_gus: DynamicGUS,
                replicas: Sequence[DynamicGUS] = ()) -> "GusEngine":
        """Restart onto a fresh engine: bootstrap from the snapshot (graph
        state restored rather than recomputed where both sides have one),
        then replay the mutation-log suffix (onto the new replicas too).
        The log is appended at submit time, so batches that were still in
        flight in a crashed pipeline replay too — recovery never touches
        the dead engine's device state."""
        eng = GusEngine(fresh_gus, self.cfg, replicas)
        targets = [fresh_gus, *eng.replicas]
        if (self.snapshot_state is not None
                and len(self.snapshot_state["store"]["ids"])):
            for gus in targets:
                self._restore_gus(gus, self.snapshot_state)
        # carry the snapshot forward: if the recovered engine crashes again
        # before its next snapshot, a second recover() must not lose the
        # snapshot corpus
        eng.snapshot_state = self.snapshot_state
        for batch in self.mutation_log:
            for gus in targets:
                gus.mutate(batch)
            eng.mutation_log.append(batch)
        eng.seq = len(eng.mutation_log)
        for member in [eng.primary, *eng.replica_set]:
            member.applied_seq = eng.seq
        return eng

    # --------------------------------------------------------------- stats

    def telemetry(self) -> dict:
        """One self-describing snapshot of the plane: every registry
        instrument, the retained lifecycle events, and trace-sampling
        stats (``launch/serve.py --metrics`` prints this)."""
        return self.obs.snapshot()

    def describe(self) -> dict:
        out = {
            "queries": self.queries,
            "hedged": self.hedged,
            "failovers": self.failovers,
            "seq": self.seq,
            "replica_hedges": list(self.replica_hedges),
            "primary": self.primary.describe(),
            "replicas": self.replica_set.describe(),
            "freshness": percentiles(self.freshness.samples_ms),
            "serving": self.serving.summary(),
            "query_latency": self.gus.query_timer.summary(),
            "mutation_latency": self.gus.mutation_timer.summary(),
        }
        if self.pipelines:
            out["pipeline"] = self.pipelines[0].describe()
        index_describe = getattr(self.gus.index, "describe", None)
        if callable(index_describe):
            # slab occupancy + lifecycle counters (the sharded backend)
            out["index"] = index_describe()
        if self.gus.graph is not None:
            out["graph"] = {
                **self.gus.graph.describe(),
                "maintenance_latency": self.gus.graph_timer.summary(),
            }
        return out
