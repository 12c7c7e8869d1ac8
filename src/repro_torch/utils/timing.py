"""Wall-clock timing helpers for the RPC latency percentiles (paper Figs.
9-10). Callers that time device work synchronise before leaving the timed
block (``DynamicGUS`` does, by copying results to the host)."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Timer:
    """Collects per-call wall-clock samples; reports paper-style percentiles."""
    name: str = ""
    samples_ms: list = field(default_factory=list)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples_ms.append((time.perf_counter() - self._t0) * 1e3)
        return False

    def record(self, seconds: float) -> None:
        """Add a sample measured elsewhere (the pipeline's stage times)."""
        self.samples_ms.append(seconds * 1e3)

    def summary(self) -> dict:
        return percentiles(self.samples_ms)


def percentiles(samples_ms) -> dict:
    if not len(samples_ms):
        return {}
    a = np.asarray(samples_ms)
    return {
        "n": int(a.size),
        "mean_ms": float(a.mean()),
        "p50_ms": float(np.percentile(a, 50)),
        "p95_ms": float(np.percentile(a, 95)),
        "p99_ms": float(np.percentile(a, 99)),
        "max_ms": float(a.max()),
    }
