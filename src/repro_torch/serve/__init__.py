"""Serving layer: the operational wrap around ``core.gus.DynamicGUS``
(port of ``repro/serve``).

  engine.py      — ``GusEngine``: request batching, straggler hedging and
                   fail-over across a replica group, mutation log +
                   snapshot/recover, per-replica freshness catch-up;
  replica.py     — ``Replica``/``ReplicaSet``: health, ``applied_seq``
                   freshness clocks, eligibility, round-robin hedge pick;
  frontend.py    — ``Frontend``: bounded-queue admission over mixed
                   query+mutate traffic with class-based shedding and
                   backpressure to the mutation pipeline;
  faults.py      — ``FaultInjector``: deterministic scripted faults
                   (kill/slow/partition a replica, delay a batch);
  pipeline.py    — ``MutationPipeline``: the double-buffered write path
                   (fuse windows over the two-phase backend entry points,
                   bitwise the synchronous path at staleness bound 0 — the
                   module doc lists the window-closing rules);
  maintenance.py — ``MaintenanceWorker``: the concurrent maintenance
                   plane's deferred graph ticks (staleness bound > 0);
  serve_step.py  — ``make_prefill_step`` / ``make_decode_step``: the LM
                   tower's serving steps (``models/``).

Every component reports through one ``repro_torch.obs.Telemetry`` plane
per engine; ``GusEngine.telemetry()`` snapshots it. The instrument
catalog is docs/OBSERVABILITY.md.
"""
from repro_torch.obs import Telemetry
from repro_torch.serve.engine import (EngineConfig, GusEngine,
                                      ServingUnavailableError)
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.frontend import Frontend, FrontendConfig
from repro_torch.serve.maintenance import MaintenanceWorker
from repro_torch.serve.pipeline import MutationPipeline, PipelineConfig
from repro_torch.serve.replica import Replica, ReplicaSet
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

__all__ = ["EngineConfig", "FaultInjector", "Frontend", "FrontendConfig",
           "GusEngine", "MaintenanceWorker", "MutationPipeline",
           "PipelineConfig", "Replica", "ReplicaSet",
           "ServingUnavailableError", "Telemetry", "make_decode_step",
           "make_prefill_step"]
