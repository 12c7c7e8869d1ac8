"""Metrics registry: counters, gauges, fixed-bucket histograms, exporters
(the port's own copy of ``repro/obs/registry.py``: pure Python, so both
packages give the same snapshots and the same exporter text).

The serving plane's always-on instrument panel. Every component of the
plane (``serve.frontend``, ``serve.engine``, ``serve.pipeline``,
``ann.sharded_index``) registers its instruments here at construction
time — registration is **eager**, so the set of exported metric names is
a deterministic function of the components built, which is what lets
``tools/check_metrics.py`` validate the exporter output against the
documented catalog (docs/OBSERVABILITY.md) with no traffic-dependent
holes.

Design constraints (why it looks the way it does):

* **cheap always-on recording** — ``Counter.inc`` is an integer add;
  ``Histogram.observe`` is a bisect over ~18 fixed bucket bounds plus a
  bounded-deque append. No locks (the plane is single-threaded per
  process), no label cardinality, no allocation on the hot path.
* **snapshot / delta semantics** — ``snapshot()`` captures every
  instrument's current value; ``delta(prev)`` returns the change since a
  previous snapshot (counters and histogram counts/sums subtract;
  gauges report current). This is the per-scrape shape a poller wants.
* **two exporters** — ``to_json()`` (machine-readable, benchmark
  artifacts) and ``to_prometheus()`` (the text exposition format:
  ``# HELP`` / ``# TYPE`` lines, cumulative ``_bucket{le=...}`` rows).
* **naming contract** — instrument names are validated against
  ``NAME_RE`` at registration (lowercase ``snake_case``); the repo
  convention (enforced by ``tools/lint.py``) additionally namespaces
  names by component prefix (``frontend_`` / ``engine_`` / ``pipeline_``
  / ``index_`` / ``obs_``) with ``_total`` for counters, ``_ms`` for
  latency histograms, ``_ratio`` for dimensionless gauges.

``Histogram`` is API-compatible with ``utils.timing.Timer`` (``record``
seconds, ``samples_ms``, ``summary()``, context manager) so the serving
components could swap their ad-hoc timers for registry-backed
instruments without changing the ``stats()`` dict shapes tests pin;
``summary()`` delegates to ``utils.timing.percentiles`` — the single
percentile implementation in the repo — over a bounded window of recent
raw samples, while the exporters use the fixed bucket counts.
"""
from __future__ import annotations

import bisect
import json
import re
import time
from collections import deque

from repro_torch.utils.timing import percentiles

NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# fixed latency bucket upper bounds, in ms (+Inf is implicit): spans
# sub-ms jitted device calls through multi-second saturation queueing
DEFAULT_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                      50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 30000.0)
# recent raw samples kept per histogram for exact percentile summaries
# (the exporters use the bucket counts; the window only feeds summary())
SAMPLE_WINDOW = 8192


class Counter:
    """Monotonic event count (export suffix convention: ``_total``)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (queue depth, ratio, high-water mark)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def max(self, v: float) -> None:
        """High-water-mark update (keep the larger of current and v)."""
        if v > self.value:
            self.value = float(v)


class Histogram:
    """Fixed-bucket latency histogram (ms), Timer-compatible.

    ``observe(ms)`` updates count/sum/min/max, the cumulative bucket
    counts, and a bounded window of recent raw samples. ``summary()``
    reports the ``utils.timing.percentiles`` dict shape over the window
    (exact for the first ``SAMPLE_WINDOW`` observations — every test and
    bench in the repo stays far below it); exporters use the buckets.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets=DEFAULT_MS_BUCKETS, window: int = SAMPLE_WINDOW):
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in buckets)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"{name}: bucket bounds must be strictly "
                             "increasing")
        self.bucket_counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self.count = 0
        self.sum = 0.0
        self.samples_ms: deque = deque(maxlen=window)

    def observe(self, ms: float) -> None:
        ms = float(ms)
        self.bucket_counts[bisect.bisect_left(self.bounds, ms)] += 1
        self.count += 1
        self.sum += ms
        self.samples_ms.append(ms)

    # --- Timer API compatibility (record seconds / context manager) ---

    def record(self, seconds: float) -> None:
        self.observe(seconds * 1e3)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.observe((time.perf_counter() - self._t0) * 1e3)
        return False

    def reset(self) -> None:
        """Drop every recorded observation (benchmarks clear warm-up)."""
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.samples_ms.clear()

    def summary(self) -> dict:
        return percentiles(self.samples_ms)

    def cumulative(self) -> list:
        """Cumulative bucket counts aligned with ``bounds`` + (+Inf)."""
        out, acc = [], 0
        for c in self.bucket_counts:
            acc += c
            out.append(acc)
        return out


class MetricsRegistry:
    """Named instrument store with get-or-create registration."""

    def __init__(self):
        self._instruments: dict[str, object] = {}

    def _register(self, cls, name: str, help: str, **kw):
        if not NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} is not snake_case "
                "(^[a-z][a-z0-9_]*$)")
        inst = self._instruments.get(name)
        if inst is not None:
            if not isinstance(inst, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{inst.kind}")
            return inst
        inst = cls(name, help, **kw)
        self._instruments[name] = inst
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_MS_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def names(self) -> list[str]:
        return sorted(self._instruments)

    def get(self, name: str):
        return self._instruments.get(name)

    # ------------------------------------------------------ snapshot/delta

    def snapshot(self) -> dict:
        """Every instrument's current value, keyed by name."""
        out = {}
        for name, inst in sorted(self._instruments.items()):
            if inst.kind == "histogram":
                out[name] = {"type": "histogram", "count": inst.count,
                             "sum": inst.sum,
                             "buckets": dict(zip(
                                 [*inst.bounds, float("inf")],
                                 inst.cumulative()))}
            else:
                out[name] = {"type": inst.kind, "value": inst.value}
        return out

    def delta(self, prev: dict) -> dict:
        """Change since ``prev`` (an earlier ``snapshot()``): counters and
        histogram count/sum subtract; gauges report their current value
        (a gauge has no meaningful rate)."""
        cur = self.snapshot()
        out = {}
        for name, row in cur.items():
            old = prev.get(name)
            if row["type"] == "counter" and old is not None:
                out[name] = {"type": "counter",
                             "value": row["value"] - old["value"]}
            elif row["type"] == "histogram" and old is not None:
                out[name] = {"type": "histogram",
                             "count": row["count"] - old["count"],
                             "sum": row["sum"] - old["sum"]}
            else:
                out[name] = dict(row)
                if row["type"] == "histogram":
                    out[name].pop("buckets", None)
        return out

    # ---------------------------------------------------------- exporters

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        for name, inst in sorted(self._instruments.items()):
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            if inst.kind == "histogram":
                for le, c in zip([*inst.bounds, float("inf")],
                                 inst.cumulative()):
                    le_s = "+Inf" if le == float("inf") else f"{le:g}"
                    lines.append(f'{name}_bucket{{le="{le_s}"}} {c}')
                lines.append(f"{name}_sum {inst.sum:g}")
                lines.append(f"{name}_count {inst.count}")
            else:
                lines.append(f"{name} {inst.value:g}")
        return "\n".join(lines) + "\n"
