"""Replica groups: health, per-replica freshness, and hedge routing (port
of ``repro/serve/replica.py``; pure host bookkeeping).

``serve.engine.GusEngine`` fans every mutation batch out to a group of
full ``DynamicGUS`` copies and hedges or fails over queries across it;
this module owns the bookkeeping that makes that safe:

* ``Replica`` — one member: its ``DynamicGUS``, liveness, and
  ``applied_seq`` (the engine-assigned sequence number of the last
  mutation batch it applied — the per-replica freshness clock);
* ``ReplicaSet`` — the group: eligibility (a replica may serve only if
  it is alive, un-partitioned, and within ``staleness_batches`` of the
  committed sequence) and the round-robin hedge/fail-over pick over
  eligible members only.

The invariant: **a query is never answered by a dead replica, and never
by a stale one beyond the documented staleness bound**
(``EngineConfig.staleness_batches``, default 0 = exact freshness). A
revived or healed replica becomes eligible again only after the engine's
catch-up replays the mutation-log suffix it missed.

The registry carries plane-level aggregates only; the per-member counts
here are routing state, surfaced through ``describe()``, and the
member-attributed history is the event log's (``replica_down`` /
``replica_up`` / ``replica_partitioned`` / ``replica_healed``,
``failover``, ``catch_up``). On one card every member is its own engine
with its own device tensors; a sharded member's shards go where
``launch/mesh.py`` places its pod (``ShardedConfig.pod``): on one card,
every pod's shards share it.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.gus import DynamicGUS


@dataclasses.dataclass
class Replica:
    """One member of a replica group (see module doc)."""
    name: str
    gus: DynamicGUS
    key: object = None           # fault-injector target (PRIMARY or index)
    alive: bool = True           # False = killed (fault injection / health)
    partitioned: bool = False    # replication link down: lags, stays up
    applied_seq: int = 0         # last engine-sequence batch applied
    served: int = 0              # queries this replica answered
    hedges: int = 0              # answers that came from a hedge
    failovers: int = 0           # answers taken over from a dead primary
    catchups: int = 0            # freshness catch-ups after rejoin
    caught_up_batches: int = 0   # log-suffix batches replayed by catch-ups

    def describe(self) -> dict:
        return {"name": self.name, "alive": self.alive,
                "partitioned": self.partitioned,
                "applied_seq": self.applied_seq, "served": self.served,
                "hedges": self.hedges, "failovers": self.failovers,
                "catchups": self.catchups,
                "caught_up_batches": self.caught_up_batches}


class ReplicaSet:
    """Health/freshness-aware routing over a group of replicas."""

    def __init__(self, replicas: Sequence[Replica],
                 staleness_batches: int = 0):
        self.members = list(replicas)
        self.staleness_batches = int(staleness_batches)
        self._next = 0

    def __len__(self) -> int:
        return len(self.members)

    def __iter__(self):
        return iter(self.members)

    def eligible(self, replica: Replica, seq: int) -> bool:
        """May ``replica`` answer a query at committed sequence ``seq``?
        Alive, un-partitioned, and within the staleness bound."""
        return (replica.alive and not replica.partitioned
                and seq - replica.applied_seq <= self.staleness_batches)

    def lagging(self, seq: int) -> list[Replica]:
        """Alive, un-partitioned members behind the committed sequence —
        the set the engine's catch-up must replay the log suffix to."""
        return [r for r in self.members
                if r.alive and not r.partitioned and r.applied_seq < seq]

    def pick(self, seq: int) -> Replica | None:
        """Round-robin over *eligible* members only (dead, partitioned,
        and stale replicas are skipped; None when nobody can serve)."""
        n = len(self.members)
        for off in range(n):
            r = self.members[(self._next + off) % n]
            if self.eligible(r, seq):
                self._next = (self._next + off + 1) % n
                return r
        return None

    def describe(self) -> list[dict]:
        return [r.describe() for r in self.members]
