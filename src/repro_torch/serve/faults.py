"""Deterministic fault injection for the serving plane (the port's own
copy of ``repro/serve/faults.py``: pure host code, so both packages'
engines react to one fault script the same way).

The chaos tests need replica death, stragglers, replication partitions,
and dispatch delays that reproduce *exactly* across runs. ``FaultInjector``
is therefore completely passive and script-driven: tests (or the load
harness) call ``kill`` / ``slow`` / ``partition`` / ``delay_batch`` at
chosen points, and the serving components consult the injector at their
decision sites — nothing in here reads wall-clock time or randomness.

Fault semantics (what each scripted fault means to the plane):

* ``kill(target)`` — the target is down: it neither applies mutations
  nor serves queries. ``serve.engine`` skips it for replication (it
  falls behind — its ``applied_seq`` freezes) and never routes a query
  to it ("no accepted request is answered from a dead replica").
  ``revive(target)`` brings it back *stale*; the engine's freshness
  catch-up (mutation-log suffix replay) must run before it serves again.
* ``slow(target, extra_ms)`` — a straggler: the engine *adds*
  ``extra_ms`` to the target's measured query latency instead of
  sleeping, so hedging decisions (and the recorded serving latency the
  p95/p99 metrics see) respond to the fault deterministically and
  without stalling the test suite.
* ``partition(target)`` — a replication-plane partition: the target is
  up but mutations cannot reach it, so its ``applied_seq`` lags and the
  engine's per-replica freshness check excludes it from hedging until
  ``heal(target)`` + catch-up. (A query-plane partition is ``kill``.)
* ``delay_batch(kind, steps)`` — the request front-end holds the next
  ``steps`` dispatch rounds of the given class (``"query"`` |
  ``"mutate"``) in its queue: queueing delay and admission behavior
  under a stalled dispatcher, again without sleeping.

Targets are ``FaultInjector.PRIMARY`` (the engine's own GUS) or a
replica index ``int``. Every scripted action is appended to ``log`` so
tests can assert the schedule they think they ran.
"""
from __future__ import annotations


class FaultInjector:
    """Scripted, deterministic fault state consulted by engine/frontend."""

    PRIMARY = "primary"

    def __init__(self):
        self._killed: set = set()
        self._partitioned: set = set()
        self._slow_ms: dict = {}
        self._holds: dict[str, int] = {}
        self.log: list[tuple] = []

    # ------------------------------------------------------------- scripting

    def kill(self, target) -> None:
        self._killed.add(target)
        self.log.append(("kill", target))

    def revive(self, target) -> None:
        self._killed.discard(target)
        self.log.append(("revive", target))

    def slow(self, target, extra_ms: float) -> None:
        self._slow_ms[target] = float(extra_ms)
        self.log.append(("slow", target, float(extra_ms)))

    def clear_slow(self, target) -> None:
        self._slow_ms.pop(target, None)
        self.log.append(("clear_slow", target))

    def partition(self, target) -> None:
        self._partitioned.add(target)
        self.log.append(("partition", target))

    def heal(self, target) -> None:
        self._partitioned.discard(target)
        self.log.append(("heal", target))

    def delay_batch(self, kind: str, steps: int) -> None:
        """Hold the front-end's next ``steps`` dispatch rounds of
        ``kind`` ("query" | "mutate") in the queue."""
        self._holds[kind] = self._holds.get(kind, 0) + int(steps)
        self.log.append(("delay_batch", kind, int(steps)))

    # --------------------------------------------------------- decision sites

    def killed(self, target) -> bool:
        return target in self._killed

    def partitioned(self, target) -> bool:
        return target in self._partitioned

    def extra_ms(self, target) -> float:
        """Synthetic straggler latency added to the target's measured
        query time (never slept — see module doc)."""
        return self._slow_ms.get(target, 0.0)

    def consume_hold(self, kind: str) -> bool:
        """Front-end dispatch gate: True = skip this round (one unit of a
        scripted ``delay_batch`` is consumed)."""
        left = self._holds.get(kind, 0)
        if left <= 0:
            return False
        self._holds[kind] = left - 1
        return True
