"""What the per-layer readers (``metrics/<name>.py``) and the end-to-end
readers (``e2e/<name>.py``) read, and the arithmetic they share.

A reader is a module with ``read(t) -> float | None``; ``None`` means it
found nothing to read, and the metric is left out of the line.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass
class RunData:
    """One run: ``requests`` of the window in the order served, each a dict
    with ``kind``, ``due`` / ``start`` / ``end`` (host seconds), ``ok``
    and ``ops`` (mutations it carried); ``t0`` / ``t1`` the window;
    ``setup_s``; for a traced run ``spans`` (``SpanRecorder.records``),
    ``dev`` (``DeviceTrace.reduce()``) and ``counters`` (the program's own
    timers, cut to the window)."""
    requests: list
    t0: float
    t1: float
    setup_s: float
    spans: list = dataclasses.field(default_factory=list)
    dev: dict | None = None
    counters: dict = dataclasses.field(default_factory=dict)


# ------------------------------------------------------------ end to end

def latencies_ms(t: RunData, kind: str) -> np.ndarray:
    """Due time to answer on the host, every request of ``kind`` in the
    window (a failed one counts as never answered: +inf)."""
    return np.asarray([(r["end"] - r["due"]) * 1e3 if r["ok"] else np.inf
                       for r in t.requests if r["kind"] == kind])


# ------------------------------------------------------------ host spans

def rpc_spans(t: RunData, kind: str) -> list:
    return [s for s in t.spans if s["name"] == f"rpc.{kind}"]


def layer_ms_per_rpc(t: RunData, kind: str, layers: tuple) -> float | None:
    """Mean over the window's ``kind`` requests of the time in the top
    spans of ``layers`` inside each (ms)."""
    rpcs = rpc_spans(t, kind)
    if not rpcs:
        return None
    inside = {r["rpc"]: 0.0 for r in rpcs}
    found = False
    for s in t.spans:
        if s["layer"] in layers and s["top"] and s["rpc"] in inside \
                and s["kind"] == kind and not s["name"].startswith("rpc."):
            inside[s["rpc"]] += s["t1"] - s["t0"]
            found = True
    if not found:
        return None
    return float(np.mean(list(inside.values())) * 1e3)


def self_ms_per_rpc(t: RunData, kind: str, child_layers: tuple
                    ) -> float | None:
    """Mean request span minus its child spans of ``child_layers`` (ms)."""
    rpcs = rpc_spans(t, kind)
    if not rpcs:
        return None
    child = layer_ms_per_rpc(t, kind, child_layers) or 0.0
    return float(np.mean([r["t1"] - r["t0"] for r in rpcs]) * 1e3 - child)


# ---------------------------------------------------------- device trace

def dev_spans(t: RunData, name: str) -> list:
    """Profiled host spans named ``name``: [(start_us, end_us, meta)],
    ``meta`` the JSON after ``|`` in the label (or None)."""
    if not t.dev:
        return []
    out = []
    for label, s, e in t.dev["spans"]:
        base, _, meta = label.partition("|")
        if base == name:
            out.append((s, e, json.loads(meta) if meta else None))
    return out


def union(intervals) -> list:
    """Merged, sorted [start, end] intervals."""
    out: list = []
    for s, e in sorted((s, e) for s, e in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered_us(merged: list, s: float, e: float) -> float:
    """Length of [s, e] covered by the merged intervals."""
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in merged
               if a < e and b > s)


def ops_in(t: RunData, s: float, e: float) -> list:
    """Device records that start inside [s, e]."""
    return [o for o in t.dev["ops"] if s <= o[1] <= e]


def idle_share(t: RunData, span_name: str) -> float | None:
    """Share of the time inside the profiled ``span_name`` spans with no
    device record running."""
    spans = dev_spans(t, span_name)
    if not spans or not t.dev["ops"]:
        return None
    busy = union((o[1], o[2]) for o in t.dev["ops"])
    total = sum(e - s for s, e, _ in spans)
    return float(1.0 - sum(covered_us(busy, s, e) for s, e, _ in spans)
                 / total)


def within(inner: list, outer: list) -> list:
    """The ``inner`` spans that lie inside one of the ``outer`` spans."""
    return [i for i in inner if any(o[0] <= i[0] and i[1] <= o[1]
                                    for o in outer)]
