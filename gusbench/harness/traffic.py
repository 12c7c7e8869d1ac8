"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and makes the requests of a run.

Two loops:

* ``"open"``: requests due on a fixed schedule at ``rate_per_s``, whatever
  the system does, all planned before the window opens. The gaps are the
  same for every seed (the quantiles of the exponential distribution at
  that rate, scaled to fill the window exactly) and so is the number of
  each kind of request; the seed only orders them, so every seed offers
  the same load.
* ``"closed"``: one caller runs ``cycle`` (a list of requests) again and
  again, each request sent when the previous one has returned; it makes
  each cycle's requests (``Plan.cycle``) when the previous cycle is done,
  for as long as the window lasts.

A ``mutate`` request is the next batch of ``data.MutationStream`` with the
mix's ``batch`` parameters; a ``query`` request asks for ``ids`` ids drawn
uniformly from the ids live after the batches planned before it, at
``k``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from harness.data import MutationStream


@dataclasses.dataclass
class Request:
    kind: str                 # "query" | "mutate"
    due: float = 0.0          # seconds after the window opens (open loop)
    ids: np.ndarray | None = None   # query ids
    k: int = 0
    batch: object = None      # data.Batch
    version0: int = -1        # version of the batch's first row


class Plan:
    """Requests of a run: ``warmup`` (set-up) and ``window``; every batch's
    rows numbered as feature versions after the corpus's."""

    def __init__(self, traffic: dict, stream: MutationStream, n_corpus: int,
                 rng: np.random.Generator):
        self.traffic = traffic
        self.stream = stream
        self.rng = rng
        self.next_version = n_corpus
        self.batches: list = []
        self._live = None

    def _mutate(self) -> Request:
        batch = next(self.stream)
        req = Request("mutate", batch=batch, version0=self.next_version)
        self.next_version += batch.ids.size
        self.batches.append(req)
        self._live = None
        return req

    def _query(self, ids: int, k: int) -> Request:
        if self._live is None:
            self._live = np.fromiter(self.stream.live, np.int64,
                                     len(self.stream.live))
        pick = self.rng.integers(0, self._live.size, ids)
        return Request("query", ids=self._live[pick], k=k)

    def _make(self, spec: dict) -> Request:
        if spec["rpc"] == "mutate":
            return self._mutate()
        return self._query(spec["ids"], spec["k"])

    def warmup(self) -> list:
        """Set-up requests: every shape the window will use, in the
        window's proportions."""
        w = self.traffic["warmup"]
        out = []
        for _ in range(w["rounds"]):
            out += [self._make(s) for s in self._round()]
        return out

    def _round(self) -> list:
        if self.traffic["loop"] == "closed":
            return self.traffic["cycle"]
        return [s for s in self.traffic["mix"] for _ in range(s["share"])]

    def cycle(self) -> list:
        """The closed loop's next cycle of requests."""
        return [self._make(s) for s in self.traffic["cycle"]]

    def window(self, seconds: float) -> list:
        """The open loop's requests, each with its due time."""
        t = self.traffic
        n = max(1, int(round(t["rate_per_s"] * seconds)))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
        gaps *= seconds / gaps.sum()
        gaps = self.rng.permutation(gaps)
        due = np.cumsum(gaps) - gaps[0]
        shares = [s["share"] for s in t["mix"]]
        counts = [int(round(n * s / sum(shares))) for s in shares]
        counts[0] += n - sum(counts)
        kinds = self.rng.permutation(np.repeat(np.arange(len(shares)),
                                               counts))
        out = []
        for d, kind in zip(due.tolist(), kinds.tolist()):
            req = self._make(t["mix"][kind])
            req.due = d
            out.append(req)
        return out
