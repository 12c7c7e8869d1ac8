"""Request front-end: admission control over mixed query+mutate traffic
(port of ``repro/serve/frontend.py``; pure host code over ``GusEngine``).

The serving plane's front door. Producers ``submit_query`` /
``submit_mutation``; the front-end queues them per class in bounded FIFO
queues, and ``step()`` dispatches one scheduling round into the
``GusEngine`` (queries batched into fused engine calls, mutations fed to
the async write path). This is where the paper's "tens of milliseconds
per request under heavy traffic" becomes an admission problem rather
than an index problem: under overload the queues fill, and the
front-end *sheds* — with an explicit rejection, never silence.

Admission contract (pinned by ``tests/test_frontend.py`` for the
reference and ``tests/test_torch_serve.py`` for the port):

* **bounded queues** — each class's queue never exceeds its configured
  bound; a submit that would overflow is rejected immediately with
  status ``"shed_capacity"``;
* **backpressure** — mutate admissions are additionally rejected with
  ``"shed_backpressure"`` while the engine's unflushed write backlog
  (rows dispatched since the last flush/query, plus the async
  pipeline's staged windows) exceeds ``max_unflushed`` — the queue
  bound protects the front-end, this bound protects the mutation
  pipeline behind it;
* **no reordering within a class** — queues are FIFO and dispatch pops
  from the head, so responses complete in admission order per class
  (classes may interleave with each other; that is the point of having
  two);
* **no lost accepted requests** — every accepted request id receives
  exactly one terminal response (``"ok"`` or ``"error"``) from
  ``step()``/``drain()``; shed requests receive theirs at submit time.
  ``ServingUnavailableError`` from the engine (every replica dead)
  becomes an explicit ``"error"`` response, not an exception up the
  stack and not a dropped ticket.

Dispatch: each ``step()`` first dispatches up to ``mutate_dispatch``
mutate requests (so writes admitted earlier are visible to queries
dispatched the same round — the engine's query path flushes), then up to
``query_dispatch`` query requests. Consecutive head-of-queue queries
with the same ``k`` fuse into one padded engine call and are split back
per request. A scripted ``FaultInjector.delay_batch`` holds a class's
dispatch for N rounds (queueing-delay injection, no sleeping).

Equivalence: given the same admitted sequence and step schedule, a
front-end over a pipelined engine produces bit-identical query responses
to one over a synchronous engine — the engine flushes before every
query, so the staleness bound at the front door is
``EngineConfig.staleness_batches`` (default 0: read-your-dispatched-
writes exactly).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.core.types import MutationBatch, NeighborResult
from repro_torch.obs import Telemetry
from repro_torch.serve.engine import GusEngine, ServingUnavailableError
from repro_torch.serve.faults import FaultInjector


class _ClassCounts:
    """Mapping view over per-class registry counters: reads and ``dict()``
    behave like the plain ``{"query": n, "mutate": n}`` dicts the tests
    pin, while every increment lands in the shared registry."""

    def __init__(self, counters: dict):
        self._counters = counters

    def __getitem__(self, kind: str) -> int:
        return self._counters[kind].value

    def inc(self, kind: str, n: int = 1) -> None:
        self._counters[kind].inc(n)

    def keys(self):
        return self._counters.keys()

    def __iter__(self):
        return iter(self._counters)

    def values(self):
        return [c.value for c in self._counters.values()]

    def items(self):
        return [(k, c.value) for k, c in self._counters.items()]


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    query_queue: int = 256        # bounded admission queue, query class
    mutate_queue: int = 64        # bounded admission queue, mutate class
    query_dispatch: int = 8       # max query requests dispatched per step
    mutate_dispatch: int = 4      # max mutate requests dispatched per step
    # backpressure bound: mutation rows admitted but not yet
    # flush-visible (plus staged pipeline windows) before mutate
    # admissions shed
    max_unflushed: int = 4096


@dataclasses.dataclass
class Request:
    rid: int
    kind: str                     # "query" | "mutate"
    payload: object               # features dict | MutationBatch
    k: int | None = None
    rows: int = 1                 # mutation rows (backpressure accounting)
    arrival_s: float = 0.0        # submit time (loadgen may backdate to
    #                               the scheduled arrival — open-loop
    #                               latency counts queueing, not the
    #                               harness's submit jitter)


@dataclasses.dataclass
class Response:
    rid: int
    kind: str
    status: str                   # "accepted" | "ok" | "error" |
    #                               "shed_capacity" | "shed_backpressure"
    result: object = None         # NeighborResult slice (query, "ok")
    latency_ms: float = 0.0       # completion - arrival (terminal only)
    detail: str = ""

    @property
    def terminal(self) -> bool:
        return self.status != "accepted"

    @property
    def shed(self) -> bool:
        return self.status.startswith("shed")


class Frontend:
    """Bounded-queue admission + batched dispatch over a ``GusEngine``."""

    def __init__(self, engine: GusEngine,
                 cfg: FrontendConfig = FrontendConfig(),
                 faults: FaultInjector | None = None,
                 clock=time.perf_counter,
                 telemetry: Telemetry | None = None):
        self.engine = engine
        self.cfg = cfg
        # share the engine's injector unless the caller scripts another
        self.faults = faults or engine.faults
        self.clock = clock
        # join the engine's telemetry plane: one registry per plane
        self.obs = telemetry if telemetry is not None else engine.obs
        reg = self.obs.registry
        self.accepted = _ClassCounts({
            k: reg.counter(f"frontend_accepted_{k}_total",
                           f"{k} requests admitted")
            for k in ("query", "mutate")})
        self.shed = _ClassCounts({
            k: reg.counter(f"frontend_shed_{k}_total",
                           f"{k} requests shed at admission")
            for k in ("query", "mutate")})
        self.completed = _ClassCounts({
            k: reg.counter(f"frontend_completed_{k}_total",
                           f"{k} requests answered ok")
            for k in ("query", "mutate")})
        self._c_shed_capacity = reg.counter(
            "frontend_shed_capacity_total", "sheds from a full queue")
        self._c_shed_backpressure = reg.counter(
            "frontend_shed_backpressure_total",
            "mutate sheds from unflushed-write backpressure")
        self._c_errors = reg.counter(
            "frontend_errors_total", "accepted requests answered error")
        self._c_steps = reg.counter(
            "frontend_steps_total", "scheduling rounds run")
        self._g_depth = {
            k: reg.gauge(f"frontend_queue_depth_{k}",
                         f"current {k} queue depth")
            for k in ("query", "mutate")}
        self._g_high_water = {
            k: reg.gauge(f"frontend_queue_high_water_{k}",
                         f"max {k} queue depth observed")
            for k in ("query", "mutate")}
        self.query_latency = reg.histogram(
            "frontend_query_latency_ms", "admission-to-answer, query class")
        self.mutate_latency = reg.histogram(
            "frontend_mutate_latency_ms", "admission-to-ack, mutate class")
        self._queue_wait = {
            k: reg.histogram(f"frontend_queue_wait_{k}_ms",
                             f"admission-to-dispatch wait, {k} class")
            for k in ("query", "mutate")}
        self._queues: dict[str, deque] = {"query": deque(),
                                          "mutate": deque()}
        self._rid = 0
        self._unflushed_rows = 0      # mutate rows dispatched, not flushed

    @property
    def steps(self) -> int:
        return self._c_steps.value

    @property
    def errors(self) -> int:
        return self._c_errors.value

    @property
    def queue_high_water(self) -> dict:
        return {k: int(g.value) for k, g in self._g_high_water.items()}

    # ------------------------------------------------------------ admission

    def queue_depth(self, kind: str) -> int:
        return len(self._queues[kind])

    def _admit(self, req: Request) -> Response:
        limit = (self.cfg.query_queue if req.kind == "query"
                 else self.cfg.mutate_queue)
        if len(self._queues[req.kind]) >= limit:
            self.shed.inc(req.kind)
            self._c_shed_capacity.inc()
            self.obs.events.emit("admission_shed", request=req.kind,
                                 reason="capacity", rid=req.rid)
            return Response(req.rid, req.kind, "shed_capacity",
                            detail=f"queue at bound {limit}")
        if req.kind == "mutate" and self._backlog() > self.cfg.max_unflushed:
            self.shed.inc(req.kind)
            self._c_shed_backpressure.inc()
            self.obs.events.emit("admission_shed", request=req.kind,
                                 reason="backpressure", rid=req.rid)
            return Response(req.rid, req.kind, "shed_backpressure",
                            detail=f"unflushed backlog {self._backlog()} > "
                                   f"{self.cfg.max_unflushed}")
        q = self._queues[req.kind]
        q.append(req)
        self.accepted.inc(req.kind)
        self._g_depth[req.kind].set(len(q))
        self._g_high_water[req.kind].max(len(q))
        return Response(req.rid, req.kind, "accepted")

    def _backlog(self) -> int:
        """Unflushed write pressure: rows dispatched since the engine
        last flushed (any query flushes) plus queued-but-undispatched
        rows ahead in the mutate queue."""
        queued = sum(r.rows for r in self._queues["mutate"])
        return self._unflushed_rows + queued

    def submit_query(self, features: dict, k: int | None = None,
                     arrival_s: float | None = None) -> Response:
        """Admit one query request (features carry the batch dim; usually
        one row per request). Returns the admission response — status
        ``"accepted"`` (terminal response comes from ``step()``) or an
        explicit shed."""
        self._rid += 1
        now = self.clock()
        return self._admit(Request(
            self._rid, "query", features, k=k,
            arrival_s=now if arrival_s is None else arrival_s))

    def submit_mutation(self, batch: MutationBatch,
                        arrival_s: float | None = None) -> Response:
        """Admit one mutation request (a ``MutationBatch`` of any mix of
        kinds; the async pipeline behind the engine re-windows rows)."""
        self._rid += 1
        now = self.clock()
        return self._admit(Request(
            self._rid, "mutate", batch, rows=int(np.asarray(batch.ids).size),
            arrival_s=now if arrival_s is None else arrival_s))

    # ------------------------------------------------------------- dispatch

    def step(self) -> list[Response]:
        """One scheduling round: mutations first (their effects are
        visible to this round's queries via the engine's flush), then a
        fused query batch. Returns the terminal responses completed this
        round, in dispatch (= admission) order per class."""
        self._c_steps.inc()
        out: list[Response] = []
        if not self.faults.consume_hold("mutate"):
            out += self._dispatch_mutations()
        if not self.faults.consume_hold("query"):
            out += self._dispatch_queries()
        for kind, q in self._queues.items():
            self._g_depth[kind].set(len(q))
        return out

    def drain(self, max_steps: int = 100_000) -> list[Response]:
        """Run steps until both queues are empty (scripted holds still
        consume rounds). Every accepted request is terminal afterwards."""
        out: list[Response] = []
        while any(self._queues.values()):
            if self.steps >= max_steps:
                raise RuntimeError(f"drain exceeded {max_steps} steps")
            out += self.step()
        return out

    def _dispatch_mutations(self) -> list[Response]:
        out = []
        q = self._queues["mutate"]
        for _ in range(min(self.cfg.mutate_dispatch, len(q))):
            req = q.popleft()
            wait_ms = max(self.clock() - req.arrival_s, 0.0) * 1e3
            self._queue_wait["mutate"].observe(wait_ms)
            self.engine.submit_mutations(req.payload)
            self._unflushed_rows += req.rows
            lat = (self.clock() - req.arrival_s) * 1e3
            self.mutate_latency.observe(lat)
            self.completed.inc("mutate")
            out.append(Response(req.rid, "mutate", "ok",
                                result={"rows": req.rows}, latency_ms=lat))
        return out

    def _dispatch_queries(self) -> list[Response]:
        out = []
        q = self._queues["query"]
        budget = min(self.cfg.query_dispatch, len(q))
        while budget > 0:
            # fuse the head run of same-k requests into one engine call
            group = [q.popleft()]
            budget -= 1
            while budget > 0 and q and q[0].k == group[0].k:
                group.append(q.popleft())
                budget -= 1
            out += self._dispatch_query_group(group)
        return out

    def _dispatch_query_group(self, group: list[Request]) -> list[Response]:
        rows = [next(iter(r.payload.values())).shape[0] for r in group]
        feats = {key: np.concatenate(
            [np.asarray(r.payload[key]) for r in group], axis=0)
            for key in group[0].payload}
        # one trace per fused dispatch group: queue_wait children are
        # backdated per request (durations from the front-end's clock,
        # anchored to the tracer clock — the clocks may differ), then the
        # engine's spans nest under the same root
        tracer = self.obs.tracer
        trace = tracer.trace("request")
        t_dispatch = self.clock()
        waits_ms = [max(t_dispatch - r.arrival_s, 0.0) * 1e3 for r in group]
        for w in waits_ms:
            self._queue_wait["query"].observe(w)
        if trace.sampled:
            anchor = tracer.clock()
            for req, w in zip(group, waits_ms):
                trace.add_span("queue_wait", anchor - w / 1e3, anchor,
                               rid=req.rid)
            trace.annotate(n_requests=len(group), k=group[0].k)
        try:
            with tracer.activate(trace):
                res = self.engine.query(feats, group[0].k)
        except ServingUnavailableError as exc:
            # explicit rejection for every request in the fused batch —
            # an unavailable plane must never silently drop a ticket
            trace.annotate(error=str(exc))
            tracer.collect(trace)
            self._c_errors.inc(len(group))
            now = self.clock()
            return [Response(r.rid, "query", "error", detail=str(exc),
                             latency_ms=(now - r.arrival_s) * 1e3)
                    for r in group]
        tracer.collect(trace)
        # any engine query flushes the async write path: backlog drains
        self._unflushed_rows = 0
        now = self.clock()
        out = []
        lo = 0
        for req, n in zip(group, rows):
            sl = slice(lo, lo + n)
            lo += n
            lat = (now - req.arrival_s) * 1e3
            self.query_latency.observe(lat)
            self.completed.inc("query")
            out.append(Response(
                req.rid, "query", "ok", latency_ms=lat,
                result=NeighborResult(ids=res.ids[sl],
                                      weights=res.weights[sl],
                                      distances=res.distances[sl])))
        return out

    # ---------------------------------------------------------------- stats

    def describe(self) -> dict:
        return {
            "steps": self.steps,
            "accepted": dict(self.accepted),
            "shed": dict(self.shed),
            "completed": dict(self.completed),
            "errors": self.errors,
            "queued": {k: len(v) for k, v in self._queues.items()},
            "queue_high_water": dict(self.queue_high_water),
            "shed_rate": self.shed_rate(),
            "query_latency": self.query_latency.summary(),
            "mutate_latency": self.mutate_latency.summary(),
        }

    def shed_rate(self) -> float:
        total = sum(self.accepted.values()) + sum(self.shed.values())
        return (sum(self.shed.values()) / total) if total else 0.0
