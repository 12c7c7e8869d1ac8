"""Spans from the benchmark's own files, for the traced run only.

Each ``spans/<layer>.json`` names the entry points of one layer of the
program:

    {"layer": "index", "spans": [
        {"name": "search", "target": "gus.index.search"},
        {"name": "embed", "target": "gus.embedder", "call": true},
        {"name": "score", "target": "module:repro_torch.core.gus.score_pairs"},
        {"name": "rpc.query", "target": "gus.neighbors_of_ids", "rpc": "query"},
        {"name": "kernel.fused_query", "shapes": true,
         "target": "module:repro_torch.kernels.ops.pq_score_dedup_topk"}]}

A target ``gus.<path>.<attr>`` is an attribute of a live object reached
from the system (replaced on that object); ``module:<module>.<attr>`` a
module global; ``"call": true`` wraps the object's ``__call__`` through a
forwarding proxy. A span is a ``torch.profiler.record_function`` (so the
device work inside it lines up in the same trace, shapes of its tensor
arguments in the name where ``"shapes"`` asks) and closes with a device
synchronise, so its host time holds the device time it caused. A span
with ``"rpc"`` opens a request: the spans inside it record its index and
kind. A span nested in another span of its own layer is marked
``top=False`` (``ScannIndex.begin_upsert`` calls ``delete``).
"""
from __future__ import annotations

import importlib
import json
import time
from pathlib import Path

import torch


class _CallProxy:
    """Forwards every attribute to the wrapped object and spans its calls."""

    def __init__(self, obj, call):
        object.__setattr__(self, "_obj", obj)
        object.__setattr__(self, "_call", call)

    def __call__(self, *a, **kw):
        return self._call(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._obj, name)


class SpanRecorder:
    def __init__(self, device: torch.device):
        self.records: list = []
        self.stack: list = []
        self.rpc_count = 0
        self.on = False
        self._sync = (torch.cuda.synchronize if device.type == "cuda"
                      else (lambda: None))
        self._undo: list = []

    def _wrap(self, fn, name: str, layer: str, rpc: str | None,
              shapes: bool):
        rec = self

        def spanned(*a, **kw):
            if not rec.on:
                return fn(*a, **kw)
            label = "span:" + name
            if shapes:
                label += "|" + json.dumps(
                    [list(x.shape) if isinstance(x, torch.Tensor) else x
                     for x in list(a) + list(kw.values())
                     if isinstance(x, (torch.Tensor, int))])
            top = all(s["layer"] != layer for s in rec.stack)
            entry = {"name": name, "layer": layer, "top": top,
                     "rpc": rec.stack[0]["rpc"] if rec.stack else None,
                     "kind": rec.stack[0]["kind"] if rec.stack else None}
            if rpc is not None and not rec.stack:
                entry["rpc"], entry["kind"] = rec.rpc_count, rpc
                rec.rpc_count += 1
            rec.stack.append(entry)
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(label):
                    try:
                        return fn(*a, **kw)
                    finally:
                        rec._sync()
            finally:
                entry["t0"], entry["t1"] = t0, time.perf_counter()
                rec.stack.pop()
                rec.records.append(entry)
        return spanned

    def install(self, spans_dir: Path, roots: dict) -> list:
        """Wrap every target of every span file; returns the layers."""
        layers = []
        for path in sorted(spans_dir.glob("*.json")):
            spec = json.loads(path.read_text())
            layers.append(spec["layer"])
            for s in spec["spans"]:
                self._install_one(s, spec["layer"], roots)
        return layers

    def _install_one(self, s: dict, layer: str, roots: dict) -> None:
        target = s["target"]
        if target.startswith("module:"):
            mod_name, attr = target[len("module:"):].rsplit(".", 1)
            owner = importlib.import_module(mod_name)
        else:
            *path, attr = target.split(".")
            owner = roots.get(path[0])
            for p in path[1:]:
                owner = getattr(owner, p, None) if owner is not None else None
            if owner is None or not hasattr(owner, attr):
                return                      # absent in this configuration
        orig = getattr(owner, attr)
        if s.get("call"):
            new = _CallProxy(orig, self._wrap(orig, s["name"], layer,
                                              s.get("rpc"), s.get("shapes",
                                                                  False)))
        else:
            new = self._wrap(orig, s["name"], layer, s.get("rpc"),
                             s.get("shapes", False))
        setattr(owner, attr, new)
        self._undo.append((owner, attr, orig))

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()
