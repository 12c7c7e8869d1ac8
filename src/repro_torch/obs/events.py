"""Structured lifecycle events: *why* a request took the path it did (the
port's own copy of ``repro/obs/events.py``).

Counters say how often something happened; traces say how long one
request took; events record the **lifecycle transitions** in between —
the facts a chaos test needs to assert causality rather than just
termination. The serving plane emits (kinds are part of the documented
catalog, docs/OBSERVABILITY.md):

  engine    — ``replica_down`` / ``replica_up`` / ``replica_partitioned``
              / ``replica_healed`` (health transitions observed at the
              fault-injector sync), ``failover`` / ``hedge`` (routing
              decisions), ``catch_up`` (freshness rejoin: member, batches
              replayed, whether it re-bootstrapped from the snapshot),
              ``snapshot``, ``unavailable``;
  frontend  — ``admission_shed`` (class + reason: the explicit rejection
              the admission contract promises);
  pipeline  — ``window_close`` (reason: which window-closing rule fired —
              the exactness boundaries of serve/pipeline.py made
              observable);
  index     — ``compaction`` / ``slab_grow`` / ``resplit`` (the sharded
              slab lifecycle).

``EventLog`` is a bounded ring (oldest events drop first) with a
monotonic sequence number, so "did a fail-over happen between these two
phases" is answerable by sequence comparison even after wraparound.
Everything is host-side and allocation-light: emitting an event is a
dataclass construction and a deque append — safe to leave on in
production paths.
"""
from __future__ import annotations

import dataclasses
from collections import deque


@dataclasses.dataclass(frozen=True)
class Event:
    """One lifecycle transition: monotonic seq, kind, free-form fields."""
    seq: int
    kind: str
    fields: dict

    def __getitem__(self, key):
        return self.fields[key]


class EventLog:
    """Bounded, ordered lifecycle-event ring (see module doc)."""

    def __init__(self, keep: int = 4096):
        self._events: deque = deque(maxlen=keep)
        self._seq = 0

    def emit(self, kind: str, **fields) -> Event:
        self._seq += 1
        ev = Event(self._seq, kind, fields)
        self._events.append(ev)
        return ev

    def events(self, kind: str | None = None,
               since: int = 0) -> list[Event]:
        """Events in emission order, optionally filtered by kind and/or
        ``seq > since`` (pass a previous event's seq to window a phase)."""
        return [e for e in self._events
                if (kind is None or e.kind == kind) and e.seq > since]

    def last(self, kind: str | None = None) -> Event | None:
        evs = self.events(kind)
        return evs[-1] if evs else None

    def counts(self) -> dict:
        """Emission counts per kind (over the retained window)."""
        out: dict[str, int] = {}
        for e in self._events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    @property
    def seq(self) -> int:
        """Sequence number of the most recently emitted event."""
        return self._seq

    def __len__(self) -> int:
        return len(self._events)

    def __iter__(self):
        return iter(self._events)
