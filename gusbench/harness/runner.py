"""One run of one cell: set-up, the measured window, the traced readings,
and the comparison, driven by ``BENCHMARK.json`` and the files it names.

A cell is found by name in ``BENCHMARK.json``; its configuration file
names the system builder (``systems/<system>.py``) and the plain
reference (``references/<reference>.py``); its traffic is
``traffic/<mix>.json``; each metric is read by ``e2e/<name>.py`` or
``metrics/<name>.py``; the spans of the traced run come from
``spans/*.json``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

from harness import readers
from harness.data import (CorpusConfig, MutationStream, Spec,
                          labeled_pair_rows, make_dataset)
from harness.judge import Judge
from harness.spans import SpanRecorder
from harness.trace import DeviceTrace
from harness.traffic import Plan

BENCH = Path(__file__).resolve().parents[1]
SEED_TAGS = {"corpus": 1, "stream": 2, "pairs": 3, "scorer": 4, "lsh": 5,
             "schedule": 6, "sample": 7}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def derive_seeds(seed: int) -> dict:
    """A 31-bit seed per use, all drawn from the run's ``--seed``."""
    base = int(seed) & (2 ** 64 - 1)
    return {name: int(np.random.SeedSequence([base, tag]).generate_state(1)[0]
                      & 0x7FFFFFFF) for name, tag in SEED_TAGS.items()}


def load_module(path: Path):
    name = "gb_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def lsh_planes(spec, buckets: dict) -> dict:
    """The SimHash planes of a run's LSH, as ``buckets["seed"]`` draws
    them: one ``torch.Generator`` on the CPU, the dense modes in sorted
    order, ``[tables, dim, bits]`` standard normals for each in turn."""
    gen = torch.Generator().manual_seed(int(buckets["seed"]))
    return {name: torch.randn((buckets["dense_tables"], dim,
                               buckets["dense_bits"]), generator=gen,
                              dtype=torch.float32)
            for name, dim in sorted(spec.dense)}


def merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(base[k], v) if isinstance(v, dict) and \
            isinstance(base.get(k), dict) else v
    return out


def cell_files(root: Path, cell: str, bench: Path = BENCH) -> tuple:
    """The cell's configuration and traffic, and the end-to-end and
    per-layer metrics of ``BENCHMARK.json`` that it reports."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if wl is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{wl['traffic']}.json")
                         .read_text())

    def mine(m):
        return "workloads" not in m or cell in m["workloads"]
    return (cfg, traffic, [m for m in spec["end_to_end"] if mine(m)],
            [m for m in spec["per_layer"] if mine(m)])


def _serve(system, req, log: list, window: int | None) -> dict:
    """Serve one request; ``window`` numbers the measured window it
    belongs to (None: set-up)."""
    rec = {"kind": req.kind, "req": req, "ok": True, "out": None,
           "window": window,
           "ops": int(req.batch.ids.size) if req.kind == "mutate" else 0}
    rec["start"] = time.perf_counter()
    try:
        if req.kind == "mutate":
            system.mutate(req.batch)
        else:
            rec["out"] = system.query(req.ids, req.k)
    except Exception as exc:           # a failed request is counted, not fatal
        rec["ok"] = False
        rec["error"] = f"{type(exc).__name__}: {exc}"
    rec["end"] = time.perf_counter()
    log.append(rec)
    return rec


def _open_loop(system, reqs, log, hooks, late: list, wid: int) -> tuple:
    t0 = time.perf_counter() + 0.05
    for i, req in enumerate(reqs):
        due = t0 + req.due
        if time.perf_counter() < due:
            # spin, not sleep: the generator's wait puts the core to sleep
            # no more than a loaded server's would be
            while time.perf_counter() < due:
                pass
            late.append(time.perf_counter() - due)
        rec = _serve(system, req, log, wid)
        rec["due"] = due
        hooks.after(i)
    return t0, max(r["end"] for r in log if r["window"] == wid)


def _closed_loop(system, plan, log, hooks, seconds: float,
                 wid: int) -> tuple:
    """Cycles of requests, each made when the previous cycle is done,
    until ``seconds`` have passed."""
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        for req in plan.cycle():
            rec = _serve(system, req, log, wid)
            rec["due"] = rec["start"]
            hooks.after(i)
            i += 1
    return t0, log[-1]["end"]


class _Hooks:
    """Stops the device trace (started before the window) after the
    window's ``n``-th request."""

    def __init__(self, dev_trace: DeviceTrace | None, n: int):
        self.dev_trace, self.n = dev_trace, n

    def after(self, i: int) -> None:
        if self.dev_trace is not None and i == self.n - 1:
            self.finish()

    def finish(self) -> None:
        if self.dev_trace is not None and not self.dev_trace.stopped:
            self.dev_trace.stop()


class Run:
    """One process's run of one cell: ``setup`` (inputs, the system, the
    warm-up), then one or more ``measure`` windows, then ``judge``."""

    def __init__(self, root: Path, cell: str, seed: int, *,
                 device: str = "cuda", overrides: dict | None = None,
                 t_start: float | None = None, bench: Path = BENCH):
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.bench_dir = bench
        cfg, traffic, self.e2e, self.per_layer = cell_files(root, cell, bench)
        self.cfg = merge(cfg, (overrides or {}).get("config"))
        self.traffic = merge(traffic, (overrides or {}).get("traffic"))
        self.dev = torch.device(device)
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.seeds = derive_seeds(seed)
        self.ref = load_module(bench / "references"
                               / f"{self.cfg['reference']}.py")
        self.sysmod = load_module(bench / "systems"
                                  / f"{self.cfg['system']}.py")
        self.log: list = []
        self.windows = 0

    # ------------------------------------------------------------ set-up

    def setup(self, seconds: float, hook=None) -> list:
        """Inputs from the seed, the scorer, the system bootstrapped and
        warmed on every shape the traffic uses; returns the open loop's
        planned requests (planned here, so in set-up), or None for a
        closed loop."""
        cfg, traffic, seeds, ref = self.cfg, self.traffic, self.seeds, self.ref
        co = cfg["corpus"]
        self.spec = spec = Spec.from_json(co["spec"])
        # a set mode's item pool per cluster, where the configuration
        # states one (ogbn-products' schema draws from 40)
        sets = ({"set_vocab_per_cluster": co["set_vocab_per_cluster"]}
                if "set_vocab_per_cluster" in co else {})
        ids, self.feats, cluster = make_dataset(CorpusConfig(
            n_points=co["n_points"], n_clusters=co["n_clusters"], spec=spec,
            dense_noise=co["dense_noise"], scalar_spread=co["scalar_spread"],
            zipf_clusters=co["zipf_clusters"], seed=seeds["corpus"], **sets))
        sc = cfg["scorer"]
        pa, pb, labels = labeled_pair_rows(
            cluster, min(4 * co["n_points"], sc["train_pairs"]),
            seeds["pairs"])
        pf = ref.pair_features(
            {k: torch.as_tensor(v[pa]) for k, v in self.feats.items()},
            {k: torch.as_tensor(v[pb]) for k, v in self.feats.items()},
            spec, torch.float32)
        self.params = ref.train_scorer(
            pf, torch.as_tensor(labels), seed=seeds["scorer"],
            hidden=sc["hidden"], steps=sc["steps"], batch=sc["batch"],
            lr=sc["lr"], device=self.dev)
        bt = traffic.get("batch", {})
        stream = MutationStream(
            ids, self.feats, seed=seeds["stream"],
            bootstrap_fraction=co["bootstrap_fraction"],
            batch_size=bt.get("size", 64),
            insert_frac=bt.get("insert_frac", 0.6),
            update_frac=bt.get("update_frac", 0.25),
            jitter=bt.get("jitter", 0.05))
        self.boot_ids, boot_feats = stream.bootstrap()
        self.plan = Plan(traffic, stream, len(ids),
                         np.random.default_rng(seeds["schedule"]))
        warm = self.plan.warmup()
        reqs = (self.plan.window(seconds) if traffic["loop"] == "open"
                else None)
        self.system = self.sysmod.System(
            cfg, spec, {k: v.clone() for k, v in self.params.items()},
            seeds["lsh"], self.dev)
        self.system.bootstrap(self.boot_ids, boot_feats)
        if hook is not None:
            hook(self.system)
        for req in warm:
            _serve(self.system, req, self.log, None)
        self._sync()
        # the set-up's objects leave the collector's generations, as a
        # server's start-up state does; the collector runs in the window
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - self.t_start
        return reqs

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------ window

    def measure(self, reqs: list | None, seconds: float, trace: bool
                ) -> tuple:
        """Serve one window; returns (RunData, extra, device info,
        breakdown)."""
        dev, traffic, system = self.dev, self.traffic, self.system
        mark = system.mark()
        rec = dev_trace = None
        if trace:
            rec = SpanRecorder(dev)
            rec.install(self.bench_dir / "spans", {"gus": system.gus})
            rec.on = True
            dev_trace = DeviceTrace(dev)
            dev_trace.start()
        hooks = _Hooks(dev_trace, traffic["trace_requests"] if reqs is None
                       else min(traffic["trace_requests"], len(reqs)))
        late: list = []
        n0 = len(self.log)
        wid = self.windows
        self.windows += 1
        if reqs is not None:
            t0, t1 = _open_loop(system, reqs, self.log, hooks, late, wid)
        else:
            t0, t1 = _closed_loop(system, self.plan, self.log, hooks,
                                  seconds, wid)
        hooks.finish()
        self._sync()
        if rec is not None:
            rec.on = False
            rec.uninstall()
        window = self.log[n0:]
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        counters = system.counters()
        for key, name in (("mutation_timer_ms", "mutation"),
                          ("query_timer_ms", "query")):
            counters[key] = counters[key][mark[name]:]
        run = readers.RunData(
            requests=window, t0=t0, t1=t1, setup_s=self.setup_s,
            spans=rec.records if rec else [], counters=counters)
        extra = {"generator_late_ms": [float(np.percentile(late, 50) * 1e3),
                                       float(np.max(late) * 1e3)]
                 if late else None,
                 "counters": {k: v for k, v in counters.items()
                              if not k.endswith("_ms")},
                 "program_ms": {k: float(np.mean(v)) if v else None
                                for k, v in counters.items()
                                if k.endswith("_ms")}}
        device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": 1, "memory_peak_bytes": int(peak)}
        breakdown = None
        if trace:
            run.dev = dev_trace.reduce()
            run.dev["kind"] = device_info["kind"]
            busy, window_s, breakdown = _device_summary(run.dev)
            device_info["busy_s"] = busy
            device_info["window_s"] = window_s
        return run, extra, device_info, breakdown

    def metrics(self, run, trace: bool) -> dict:
        out = {}
        for m in (self.per_layer if trace else self.e2e):
            mod = load_module(self.bench_dir / ("metrics" if trace else "e2e")
                              / f"{m['name']}.py")
            value = mod.read(run)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out

    # -------------------------------------------------------- comparison

    def judge(self, control: bool = False, both: bool = False):
        """Read the program's final state, free it, and compare: the
        program's checks, or the control's (``control``), or both as a
        pair (``both``)."""
        state = self.system.read_state()
        self.system.close()
        self.system = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        cfg, ref, spec = self.cfg, self.ref, self.spec
        # the run's LSH: the configuration's shape under the seed that the
        # system builder was given
        buckets = {**cfg["buckets"], "seed": self.seeds["lsh"]}
        planes = lsh_planes(spec, buckets)
        versions = {k: np.concatenate([v] + [r.batch.features[k]
                                             for r in self.plan.batches])
                    for k, v in self.feats.items()}
        judge = Judge(ref, spec, buckets, planes, self.params,
                      versions, self.boot_ids, self.dev,
                      control=control or both)
        queries = [i for i, r in enumerate(self.log)
                   if r["window"] is not None and r["kind"] == "query"]
        n_pick = min(self.traffic["recall_sample"], len(queries))
        pick = set(np.random.default_rng(self.seeds["sample"]).choice(
            queries, n_pick, replace=False).tolist()) if n_pick else set()
        args = (self.log, state, pick, cfg["limits"])
        if not both:
            return judge.run(*args)
        judge.control = False
        mine = judge.run(*args)
        judge.control = True
        return mine, judge.run(*args)


def run_cell(root: Path, cell: str, seed: int, seconds: float, trace: bool,
             *, device: str = "cuda", overrides: dict | None = None,
             hook=None, control: bool = False, t_start: float | None = None,
             bench: Path = BENCH) -> dict:
    """Set up, measure, read and judge one run; returns the result line
    (``checks`` last) with the program's counters under ``_extra``."""
    run = Run(root, cell, seed, device=device, overrides=overrides,
              t_start=t_start, bench=bench)
    reqs = run.setup(seconds, hook)
    data, extra, device_info, breakdown = run.measure(reqs, seconds, trace)
    gc.unfreeze()
    metrics = run.metrics(data, trace)
    t_judge = time.perf_counter()
    checks = run.judge(control)
    extra["judge_s"] = time.perf_counter() - t_judge
    window = data.requests
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": len(window),
           "failed": sum(not r["ok"] for r in window), "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    out["_extra"] = extra
    return out


def _device_summary(dev: dict) -> tuple:
    """busy_s, window_s and the breakdown of the profiled stretch."""
    ops = dev["ops"]
    window_s = (dev["t1_us"] - dev["t0_us"]) * 1e-6
    busy = readers.union((o[1], o[2]) for o in ops)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    by_name: dict = {}
    for name, s, e in ops:
        by_name[name[:96]] = by_name.get(name[:96], 0.0) + (e - s) * 1e-6
    top_ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    # each idle gap goes to the innermost host span around its middle
    edges = np.asarray([dev["t0_us"]] + [x for iv in busy for x in iv]
                       + [dev["t1_us"]])
    gs, ge = edges[0::2], edges[1::2]
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    mids = (gs + ge) / 2
    label = np.full(mids.size, "between requests", dtype=object)
    for name, s, e in sorted(dev["spans"], key=lambda sp: sp[1] - sp[2]):
        lo, hi = np.searchsorted(mids, s), np.searchsorted(mids, e, "right")
        label[lo:hi] = name.partition("|")[0]
    gaps: dict = {}
    for name, dur in zip(label.tolist(), ((ge - gs) * 1e-6).tolist()):
        gaps[name] = gaps.get(name, 0.0) + dur
    top_gaps = sorted(gaps.items(), key=lambda x: -x[1])[:10]
    return (busy_s, window_s,
            {"device_ops": [[n, v] for n, v in top_ops],
             "idle_gaps": [[n, v] for n, v in top_gaps]})
