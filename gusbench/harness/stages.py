"""The program's own stages in a traced run, for the per-layer readers
that read them (``metrics/*_ms.*.py`` of a stage, ``launches_*``).

The program opens a stage, a ``record_function`` named
``span:<layer>.<step>`` with its meta as JSON after ``|``, at each step
of an RPC while the profiler records, so the stages are in the device
trace's host spans (``t.dev["spans"]``) beside the benchmark's own. A
neighborhood RPC's root stage is ``gus.neighbors``; every reader
averages over the profiled roots. A program without stages has no
root, and every reader returns None.
"""
from __future__ import annotations

import bisect

import numpy as np

from harness import readers as R

ROOT = "gus.neighbors"
# the program's layers, as its stage names start (``<layer>.<step>``)
LAYERS = ("gus.", "embed.", "index.", "score.", "mutate.", "graph.")


def _stages(t) -> list:
    """[(name, start_us, end_us)] of the program's stages, by start (a
    parent before the child that opened in the same microsecond)."""
    if not t.dev:
        return []
    out = [(label.partition("|")[0], s, e) for label, s, e in t.dev["spans"]]
    return sorted((x for x in out if x[0].startswith(LAYERS)),
                  key=lambda x: (x[1], -x[2]))


def ms_per_rpc(t, name: str) -> float | None:
    """Time in the stages ``name`` inside each profiled root, its mean
    over the roots (ms); None without roots or without such a stage."""
    roots = R.dev_spans(t, ROOT)
    spans = R.within(R.dev_spans(t, name), roots)
    if not roots or not spans:
        return None
    return float(sum(e - s for s, e, _ in spans) / len(roots) * 1e-3)


def leaves(stages: list) -> list:
    """The stages that hold no other stage, by start. Stages of one
    thread nest, so a stage holds another iff the next to start lies
    inside it."""
    out = []
    for i, (name, s, e) in enumerate(stages):
        nxt = stages[i + 1] if i + 1 < len(stages) else None
        if nxt is None or not (s <= nxt[1] and nxt[2] <= e):
            out.append((name, s, e))
    return out


def launches_by_stage(t) -> list | None:
    """For each profiled root, {leaf stage name: device records}: a
    record belongs to the leaf stage that last opened at or before its
    start (the one that launched it, on a card that is mostly idle);
    records before the root's first leaf go under ``ROOT``. None without
    roots or device records."""
    roots = R.dev_spans(t, ROOT)
    if not roots or not t.dev["ops"]:
        return None
    leaf = leaves(_stages(t))
    starts = [s for _, s, _ in leaf]
    out = []
    for r0, r1, _ in roots:
        counts: dict = {}
        for op in R.ops_in(t, r0, r1):
            i = bisect.bisect_right(starts, op[1]) - 1
            name = leaf[i][0] if i >= 0 and starts[i] >= r0 else ROOT
            counts[name] = counts.get(name, 0) + 1
        out.append(counts)
    return out


def launches_per_rpc(t, layer: str) -> float | None:
    """Device records attributed to the leaf stages of ``layer`` (the
    stage names' first part), their mean over the profiled roots."""
    per_rpc = launches_by_stage(t)
    if per_rpc is None:
        return None
    prefix = layer + "."
    return float(np.mean([sum(n for name, n in c.items()
                              if name.startswith(prefix))
                          for c in per_rpc]))
