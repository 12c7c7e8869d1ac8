"""Per-request tracing: sampled span trees through the serving plane (the
port's own copy of ``repro/obs/trace.py``), and the stage spans that the
engine's layers open inside a request.

A ``Trace`` is one request's span tree: the front-end opens the root at
dispatch and backdates a ``queue_wait`` child to the request's admission
time; ``GusEngine.query`` nests ``engine_query`` -> ``flush`` /
``catch_up`` / ``route`` -> ``answer_primary`` / ``answer_hedge`` /
``answer_failover`` under it; ``MutationPipeline`` and
``ShardedGusIndex`` add ``encode`` / ``handoff`` / ``shard_search``
spans when they run inside a traced request. ``latency_breakdown``
reconstructs the queue-wait / service-time / hedge-wait split from these
trees.

Sampling contract (the hot path must stay fast): ``Tracer.trace()``
decides per *request group* — ``sample_every=0`` disables tracing
entirely, ``1`` traces every request, ``N`` every Nth. Unsampled
requests get the shared ``NULL_TRACE``, whose every method is a no-op,
so the per-query overhead of a disabled or unsampled tracer is a
counter increment and an attribute check.

Stages (``stage(name, **meta)``): the layers below the engine
(``core/gus.py``, ``core/embedding.py``, ``ann/scann.py``,
``core/scorer.py``, ``graph/store.py``) mark where each step of an RPC
runs, named ``<layer>.<step>``, without a tracer handle.
``Tracer.activate`` publishes a sampled trace to a module slot, and a
stage opened while it is there is a child span of it. While
``torch.profiler`` records, a stage is also a ``record_function`` named
``span:<name>``, with ``|`` and the meta as JSON after it when meta is
given, so it sits on the profiler's clock beside the device records it
launched. With neither, ``stage`` makes two checks and returns a shared
no-op; a meta value that costs something to compute is given as a
function of no arguments, called only when the stage records. A stage
never synchronises: it times the host's part of the step, and the device
records it launched carry their own times in the profiler's trace. The
serving plane is single-threaded, so one slot serves it. The stages, under
``answer_*`` in a sampled engine trace:

    gus.neighbors (ids, k)      the neighborhood RPC's root, by id or by
                                features
      gus.gather (rows, missing, dense)
                                query rows (by id), then candidate rows;
                                rows not in the store, and whether the
                                dense id table served the lookup
      embed.batch (rows)
        embed.to_device (bytes)
        embed.buckets           the SimHash einsum and the bucket-column
                                launches (kernels/buckets.py)
          embed.minhash (tables, cap)
                                a schema with a set mode only
        embed.weights           IDF, filter, dedup and its sorts
      index.search (rows, k)
        index.sketch
        index.partitions / index.shortlist / index.rescore
                                one of each per 1,024-row chunk
        index.to_host           the host waits for the search here
        index.id_map
      gus.drop_self (rows)
      score.pairs (rows)
      score.to_host
    gus.mutate (rows)           the mutation RPC
      mutate.encode             embed.batch inside
      mutate.apply
        index.delete (rows) / index.write (rows)
      mutate.finish             the visibility barrier
      graph.apply               with a maintained graph
        graph.push_edges (rows)
      graph.repair              the repair drain

Clock discipline: every span bound in one trace comes from the tracer's
clock (``time.perf_counter`` by default). Components that account time
on a different clock (the front-end's injectable virtual clock) record
*durations* and anchor them to the tracer clock (``add_span`` with an
explicit backdated ``t0``); injected fault latency — which is added,
never slept — goes in span ``meta["extra_ms"]``, not the bounds. On the
card a kernel returns before it has run, so a span that wraps device work
ends after a host copy of its result or a synchronise, as the RPC timers
of ``core/gus.py`` do; otherwise it times the enqueue. Both
rules keep the well-formedness invariants the tests pin: single root,
no orphan spans, ``t0 <= t1`` everywhere, children inside their
parent's bounds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from collections import deque

import torch
from torch._C._autograd import _profiler_enabled

from repro_torch.utils.timing import percentiles


@dataclasses.dataclass
class Span:
    """One timed region. ``parent`` indexes ``Trace.spans`` (-1 = root)."""
    name: str
    t0: float
    t1: float | None = None
    parent: int = -1
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def duration_ms(self) -> float:
        return ((self.t1 if self.t1 is not None else self.t0)
                - self.t0) * 1e3

    @property
    def effective_ms(self) -> float:
        """Wall duration plus injected (never-slept) fault latency."""
        return self.duration_ms + float(self.meta.get("extra_ms", 0.0))


class Trace:
    """A single request's span tree (see module doc)."""

    def __init__(self, name: str, clock=time.perf_counter,
                 t0: float | None = None):
        self.clock = clock
        self.spans: list[Span] = [Span(name, clock() if t0 is None else t0)]
        self._stack: list[int] = [0]

    @property
    def root(self) -> Span:
        return self.spans[0]

    @property
    def sampled(self) -> bool:
        return True

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        """Open a child of the innermost open span for the with-block."""
        sp = Span(name, self.clock(), parent=self._stack[-1], meta=meta)
        idx = len(self.spans)
        self.spans.append(sp)
        self._stack.append(idx)
        try:
            yield sp
        finally:
            sp.t1 = self.clock()
            self._stack.pop()

    def add_span(self, name: str, t0: float, t1: float, **meta) -> Span:
        """Record an already-timed region (e.g. a backdated queue wait)
        as a child of the innermost open span. A backdated ``t0`` widens
        every open ancestor so children always sit inside their parent's
        bounds."""
        sp = Span(name, t0, t1, parent=self._stack[-1], meta=meta)
        self.spans.append(sp)
        for idx in self._stack:
            if t0 < self.spans[idx].t0:
                self.spans[idx].t0 = t0
        return sp

    def annotate(self, **meta) -> None:
        self.spans[self._stack[-1]].meta.update(meta)

    def finish(self) -> "Trace":
        now = self.clock()
        for idx in reversed(self._stack):
            if self.spans[idx].t1 is None:
                self.spans[idx].t1 = now
        self._stack = [0]
        return self

    def find(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def problems(self) -> list[str]:
        """Well-formedness violations (empty = well-formed): exactly one
        root, every parent exists and encloses its children, monotonic
        bounds."""
        out = []
        roots = [s for s in self.spans if s.parent < 0]
        if len(roots) != 1 or self.spans[0].parent != -1:
            out.append(f"expected a single root span, got {len(roots)}")
        for i, s in enumerate(self.spans):
            if s.t1 is None:
                out.append(f"span {s.name!r} never closed")
                continue
            if s.t1 < s.t0:
                out.append(f"span {s.name!r} has t1 < t0")
            if s.parent >= 0:
                if not (0 <= s.parent < len(self.spans)) or s.parent >= i:
                    out.append(f"span {s.name!r} has orphan parent "
                               f"{s.parent}")
                    continue
                p = self.spans[s.parent]
                eps = 1e-9
                if s.t0 < p.t0 - eps or (p.t1 is not None
                                         and s.t1 > p.t1 + eps):
                    out.append(f"span {s.name!r} escapes parent "
                               f"{p.name!r} bounds")
        return out


class NullTrace:
    """Shared no-op trace handed to unsampled requests."""

    sampled = False
    spans: list = []

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        yield None

    def add_span(self, name: str, t0: float, t1: float, **meta):
        return None

    def annotate(self, **meta) -> None:
        pass

    def finish(self) -> "NullTrace":
        return self

    def find(self, name: str) -> list:
        return []

    def problems(self) -> list:
        return []


NULL_TRACE = NullTrace()


# ------------------------------------------------------------------ stages

# the sampled trace that ``Tracer.activate`` published for the stages
_published: Trace | None = None


class _NoStage:
    """What a stage is while nothing records: one shared no-op."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_STAGE = _NoStage()


class _Stage:
    """A stage while something records: a ``record_function`` when the
    profiler is on, a child span when a sampled trace is published."""

    __slots__ = ("name", "meta", "trace", "profiled", "_rf", "_span")

    def __init__(self, name: str, meta: dict, trace, profiled: bool):
        self.name = name
        self.meta = {k: v() if callable(v) else v for k, v in meta.items()}
        self.trace, self.profiled = trace, profiled
        self._rf = self._span = None

    def __enter__(self):
        if self.profiled:
            label = "span:" + self.name
            if self.meta:
                label += "|" + json.dumps(self.meta)
            self._rf = torch.profiler.record_function(label)
            self._rf.__enter__()
        if self.trace is not None:
            self._span = self.trace.span(self.name, **self.meta)
            return self._span.__enter__()
        return None

    def __exit__(self, *exc):
        try:
            if self._span is not None:
                self._span.__exit__(*exc)
        finally:
            if self._rf is not None:
                self._rf.__exit__(*exc)
        return False


def stage(name: str, **meta):
    """A context for one step of a request, named ``<layer>.<step>``; its
    meta values are numbers, or functions that return one (see the
    module doc). No-op unless the profiler records or a sampled trace is
    published."""
    profiled = _profiler_enabled()
    if _published is None and not profiled:
        return _NO_STAGE
    return _Stage(name, meta, _published, profiled)


class Tracer:
    """Sampling trace factory + the active-trace context (see module doc).

    ``sample_every``: 0 = tracing off, 1 = every request, N = every Nth.
    Finished sampled traces collect in a bounded ``finished`` deque for
    the latency-breakdown harness and the span-tree tests.
    """

    def __init__(self, sample_every: int = 16, keep: int = 2048,
                 clock=time.perf_counter):
        self.sample_every = int(sample_every)
        self.clock = clock
        self.finished: deque = deque(maxlen=keep)
        self.active: Trace | NullTrace | None = None
        self.started = 0       # sampling decisions taken
        self.sampled = 0       # decisions that produced a real trace

    def trace(self, name: str, t0: float | None = None):
        """Sampling decision + trace construction for one request."""
        self.started += 1
        if (self.sample_every <= 0
                or (self.started - 1) % self.sample_every):
            return NULL_TRACE
        self.sampled += 1
        return Trace(name, clock=self.clock, t0=t0)

    @contextlib.contextmanager
    def activate(self, trace):
        """Make ``trace`` the ambient trace: components below this frame
        attach spans via ``span()``/``add_span()`` without threading a
        handle through every signature; a sampled trace is also published
        to the stages (``stage``)."""
        global _published
        prev, self.active = self.active, trace
        prev_published = _published
        _published = trace if trace is not None and trace.sampled else None
        try:
            yield trace
        finally:
            self.active = prev
            _published = prev_published

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        """Child span on the active trace; no-op when nothing is active
        or the active trace is unsampled."""
        if self.active is None or not self.active.sampled:
            yield None
            return
        with self.active.span(name, **meta) as sp:
            yield sp

    def add_span(self, name: str, t0: float, t1: float, **meta):
        if self.active is None or not self.active.sampled:
            return None
        return self.active.add_span(name, t0, t1, **meta)

    def collect(self, trace) -> None:
        """Finish a trace and retain it (no-op for unsampled traces)."""
        if trace is not None and trace.sampled:
            self.finished.append(trace.finish())

    def describe(self) -> dict:
        return {"sample_every": self.sample_every, "started": self.started,
                "sampled": self.sampled, "finished": len(self.finished)}


# span names the latency breakdown aggregates
QUEUE_WAIT = "queue_wait"
SERVICE_SPANS = ("answer_primary", "answer_failover")
HEDGE_SPAN = "answer_hedge"


def latency_breakdown(traces) -> dict:
    """Reconstruct per-stage latency percentiles from finished traces.

    Returns ``{"queue_wait": {...}, "service": {...}, "hedge_wait":
    {...}}`` in the ``utils.timing.percentiles`` dict shape. One trace
    covers one fused dispatch group: each ``queue_wait`` child is one
    request's admission-to-dispatch wait; the group's service time (the
    first eligible member's answer, injected straggler ms included) and
    hedge wait (the reissued answer the group waited for past the hedge
    deadline; 0 when no hedge fired) are attributed to every request in
    the group — that is what each caller actually experienced."""
    queue, service, hedge = [], [], []
    for tr in traces:
        waits = tr.find(QUEUE_WAIT)
        n_reqs = max(len(waits), 1)
        queue.extend(s.effective_ms for s in waits)
        svc = sum(s.effective_ms for name in SERVICE_SPANS
                  for s in tr.find(name))
        hdg = sum(s.effective_ms for s in tr.find(HEDGE_SPAN))
        service.extend([svc] * n_reqs)
        hedge.extend([hdg] * n_reqs)
    return {"queue_wait": percentiles(queue),
            "service": percentiles(service),
            "hedge_wait": percentiles(hedge)}
