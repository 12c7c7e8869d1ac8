"""Telemetry plane: metrics registry, per-request tracing, lifecycle
events (port of ``repro/obs``, pure Python, a copy of each module).

  registry.py — ``MetricsRegistry``: counters / gauges / fixed-bucket
                histograms with cheap always-on recording, snapshot and
                delta semantics, JSON + Prometheus text exporters;
  trace.py    — ``Tracer``/``Trace``: sampled per-request span trees,
                plus ``latency_breakdown`` (queue-wait / service /
                hedge-wait percentiles from trace data);
  events.py   — ``EventLog``: structured lifecycle transitions.

``Telemetry`` bundles the three behind one handle. In the port the
multi-modal store (``multimodal/store.py``) binds its instruments on one;
the serving plane and the sharded index (``bind_telemetry``) share
theirs the same way.
"""
from __future__ import annotations

import time

from repro_torch.obs.events import Event, EventLog
from repro_torch.obs.registry import (DEFAULT_MS_BUCKETS, Counter, Gauge,
                                      Histogram, MetricsRegistry)
from repro_torch.obs.trace import (NULL_TRACE, NullTrace, Span, Trace,
                                   Tracer, latency_breakdown)

# default per-request trace sampling: every 16th request group carries a
# span tree (0 = off, 1 = always-on)
DEFAULT_SAMPLE_EVERY = 16

__all__ = ["Counter", "DEFAULT_MS_BUCKETS", "DEFAULT_SAMPLE_EVERY", "Event",
           "EventLog", "Gauge", "Histogram", "MetricsRegistry", "NULL_TRACE",
           "NullTrace", "Span", "Telemetry", "Trace", "Tracer",
           "latency_breakdown"]


class Telemetry:
    """One serving plane's registry + tracer + event log."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None,
                 events: EventLog | None = None,
                 sample_every: int = DEFAULT_SAMPLE_EVERY,
                 clock=time.perf_counter):
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.tracer = tracer if tracer is not None else \
            Tracer(sample_every=sample_every, clock=clock)
        self.events = events if events is not None else EventLog()

    def snapshot(self) -> dict:
        """One self-describing dump: metrics, recent events, trace stats."""
        return {
            "metrics": self.registry.snapshot(),
            "events": [{"seq": e.seq, "kind": e.kind, **e.fields}
                       for e in self.events],
            "traces": self.tracer.describe(),
        }
