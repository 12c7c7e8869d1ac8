"""Smoke run of the PyTorch/CUDA port on one card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit if it fails:

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
2. drive the main path at ogbn-arxiv scale (169,343 points, 661
   partitions): train the scorer, bootstrap 60% of the corpus (IDF/filter
   tables, k-means, SOAR assignment, codebooks, load), one mutation and
   one neighborhood RPC timed apart as set-up (they load kernel modules),
   then 20 mutation batches with a 16-id neighborhood RPC after every other
   one, and the recall of the index against the exact brute-force index on
   64 live ids drawn with a fixed seed.
   Kernel launch counts are zeroed just before and read just after; every
   kernel must have run;
3. hold every kernel against its plain PyTorch version on the card at the
   shapes the main path reached (the slab grows with partition skew), the
   fused shortlist also at a global-scratch slab and at its edge cases
   (fused_query bitwise, sparse_dot and scorer_mlp within rtol/atol 1e-6),
   and time kernel and plain version with CUDA events;
4. print one JSON line with each kernel's numbers, then the result line.

It imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
WARMUP, REPS = 3, 20


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, torch) -> float:
    """Mean device time of one call, from CUDA events after warm-up."""
    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_abs_err(got, want) -> float:
    same = got == want               # also covers matching infinities
    return float((got - want).abs().masked_fill(same, 0.0).max())


# ---------------------------------------------------------------- phase 3

def check_kernels(torch, dev, shapes: dict) -> dict:
    """Phase 3: every kernel against its plain version on the card, at the
    main path's shapes (``shapes``); the fused shortlist also at a slab
    whose scores need global scratch and at its edge cases (the inputs come
    from ``repro_torch.kernels.cases``, shared with the card tests)."""
    from repro_torch.kernels import cases, fused_query, scorer_mlp, sparse_dot

    def on_card(arrays):
        return [torch.as_tensor(a).to(dev) for a in arrays]

    rng = np.random.default_rng(0)
    report = {}

    # fused_query: the main path's 16 queries x nprobe * slab candidates,
    # k = reorder; bitwise everywhere
    b, n, k = shapes["fq_b"], shapes["fq_n"], shapes["reorder"]
    fq_cases = [("main", cases.fused_query_inputs(rng, b, n, 8, 256, n // 2,
                                                  0.1), k),
                ("scratch", cases.fused_query_inputs(rng, 4, 65536, 8, 256,
                                                     30000, 0.1), 128)]
    for name, inputs, k in fq_cases + cases.fused_query_edge_cases(rng):
        args = on_card([inputs[a] for a in cases.FQ_ORDER])
        gv, gi = fused_query.fused_query_kernel(*args, k)
        wv, wi = fused_query.fused_query_plain(*args, k)
        torch.cuda.synchronize()
        if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
            raise AssertionError(f"fused_query differs from its plain "
                                 f"version ({name})")
        print(f"[kernels] fused_query {name}: bitwise equal")
        if name == "main":
            main_args, main_k = args, k
            err = _max_abs_err(gv, wv)
    b, n, m = main_args[1].shape
    c = main_args[0].shape[2]
    # lut f32, per candidate: m code bytes, i32 id, bool valid, f32 bias;
    # out: f32 + i32 per selected entry
    bound, by = _bound_ms(
        b * m * c * 4 + b * n * (m + 4 + 1 + 4) + b * main_k * 8,
        b * n * (m + 1) + b * n)
    report["fused_query"] = dict(
        shape=f"B={b} N={n} M={m} C={c} k={main_k}", max_abs_err=err,
        ms=_time_ms(lambda: fused_query.fused_query_kernel(*main_args, main_k),
                    torch),
        plain_ms=_time_ms(lambda: fused_query.fused_query_plain(
            *main_args, main_k), torch),
        bound_ms=bound, bound_by=by)

    # sparse_dot (both forms): bitwise at unit weights, rtol/atol 1e-6 with
    # IDF-like weights. A sparse entry is a u32 index and an f32 value: the
    # function needs 8 bytes of it (the port holds indices in int64 and the
    # kernel reads their low words)
    kd = shapes["k_dims"]
    forms = {"sparse_dot_batched": (
                 sparse_dot.sparse_dot_batched, 40,
                 (shapes["fq_b"], kd), (shapes["fq_b"], shapes["reorder"], kd)),
             "sparse_dot": (sparse_dot.sparse_dot, 50_000,
                            (shapes["sd_b"], kd), (shapes["sd_n"], kd))}
    for name, (fn, vocab, q_shape, db_shape) in forms.items():
        for unit in (True, False):
            args = on_card([*cases.sparse_rows(rng, q_shape, vocab, unit),
                            *cases.sparse_rows(rng, db_shape, vocab, unit)])
            got = fn(*args)
            want = sparse_dot.sparse_dot_plain(*args)
            torch.cuda.synchronize()
            if unit:
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} differs at unit weights")
            else:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            print(f"[kernels] {name} unit={unit}: max_abs_err "
                  f"{_max_abs_err(got, want)!r}")
        b, kq = q_shape
        rows = int(np.prod(db_shape[:-1]))         # db rows read once
        bound, by = _bound_ms(b * kq * 8 + rows * kd * 8 + got.numel() * 4,
                              got.numel() * kq * kd)
        report[name] = dict(
            shape=f"q={q_shape} db={db_shape}",
            max_abs_err=_max_abs_err(got, want),
            ms=_time_ms(lambda: fn(*args), torch),
            plain_ms=_time_ms(lambda: sparse_dot.sparse_dot_plain(*args),
                              torch),
            bound_ms=bound, bound_by=by)

    # scorer_mlp: 16 queries x 10 neighbors of arxiv pair features
    b, f, h = shapes["mlp"]
    args = on_card(cases.scorer_inputs(rng, b, f, h))
    got = scorer_mlp.scorer_mlp(*args)
    want = scorer_mlp.scorer_mlp_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    print(f"[kernels] scorer_mlp B={b} F={f} H={h}: max_abs_err "
          f"{_max_abs_err(got, want)!r}")
    n_w = f * h + h * h + 3 * h + 1
    bound, by = _bound_ms(b * f * 4 + n_w * 4 + b * 4,
                          b * (2 * f * h + 2 * h * h + 2 * h + 3 * h + 4))
    report["scorer_mlp"] = dict(
        shape=f"B={b} F={f} H={h}", max_abs_err=_max_abs_err(got, want),
        ms=_time_ms(lambda: scorer_mlp.scorer_mlp(*args), torch),
        plain_ms=_time_ms(lambda: scorer_mlp.scorer_mlp_plain(*args), torch),
        bound_ms=bound, bound_by=by)
    return report


# ---------------------------------------------------------------- phase 2

def profile_rpcs(torch, gus, stream, n: int = 4) -> dict:
    """Device time by kernel, and the device's idle share, over ``n``
    neighborhood RPCs and ``n`` mutation RPCs under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for rpc in ("neighbors", "mutation"):
        work = ([stream.query_ids(16) for _ in range(n)] if rpc == "neighbors"
                else [next(stream) for _ in range(n)])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for item in work:
                if rpc == "neighbors":
                    gus.neighbors_of_ids(item)
                else:
                    gus.mutate(item)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only (kernels, copies): a CPU op also carries
        # the device time of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: e.self_device_time_total,
                     reverse=True)[:8]
        out[rpc] = dict(
            wall_ms_per_rpc=wall_ms / n, device_ms_per_rpc=busy_ms / n,
            device_idle_share=1.0 - busy_ms / wall_ms,
            top=[(e.key[:60], e.count // n,
                  e.self_device_time_total / 1e3 / n) for e in top])
        print(f"[profile] {rpc}: " + json.dumps(out[rpc]))
    return out


def run_main_path(torch, n_points: int, dev) -> tuple[dict, dict]:
    """Phase 2: both RPCs and the offline build on ``n_points`` points.
    Returns the run's metrics and the shapes its kernels were given."""
    from repro_torch.ann.brute import BruteIndex
    from repro_torch.ann.scann import ScannConfig
    from repro_torch.core.buckets import BucketConfig
    from repro_torch.core.gus import DynamicGUS, GusConfig
    from repro_torch.core.scorer import train_scorer
    from repro_torch.data.stream import MutationStream, StreamConfig
    from repro_torch.data.synthetic import (OGB_ARXIV_LIKE, labeled_pairs,
                                            make_dataset)
    from repro_torch.kernels import ops

    data = dataclasses.replace(OGB_ARXIV_LIKE, n_points=n_points)
    # the serving config launch/serve.py builds for this corpus
    cfg = GusConfig(scann_nn=10, scann=ScannConfig(
        d_proj=64, n_partitions=max(16, n_points // 256), nprobe=8,
        reorder=128))
    buckets = BucketConfig(dense_tables=8, dense_bits=10, set_tables=6,
                           scalar_widths=(2.0,))
    t0 = time.perf_counter()
    ids, feats, cluster = make_dataset(data)
    pf, lbl = labeled_pairs(feats, cluster, min(4 * n_points, 20_000),
                            data.spec, seed=0)
    stream = MutationStream(data, StreamConfig(seed=0), bootstrap_fraction=0.6)
    boot_ids, boot_feats = stream.bootstrap()
    print(f"[main] data ready in {time.perf_counter() - t0:.1f} s: "
          f"{n_points} points, {len(boot_ids)} bootstrapped, "
          f"{cfg.scann.n_partitions} partitions")

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scorer, losses = train_scorer(0, data.spec, pf, lbl, steps=300,
                                  device=dev)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"scorer loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    gus = DynamicGUS(data.spec, buckets, scorer, cfg, device=dev)
    gus.bootstrap(boot_ids, boot_feats)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    print(f"[main] scorer loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"bootstrap {boot_s:.1f} s; index {len(gus.index)} points, "
          f"capacity {gus.index.capacity}, slab {gus.index.slab}")

    # the first RPC of each kind loads kernel modules lazily: time it apart
    # as set-up, then measure the steady state
    gus.mutate(next(stream))
    gus.neighbors_of_ids(stream.query_ids(16))
    first_ms = (gus.mutation_timer.samples_ms.pop(),
                gus.query_timer.samples_ms.pop())

    same = []
    for i, batch in zip(range(20), stream):
        gus.mutate(batch)
        if i % 2 == 1:
            qids = stream.query_ids(16)
            res = gus.neighbors_of_ids(qids)
            if res.ids.shape != (16, 10) or not np.isfinite(
                    res.weights[res.ids >= 0]).all():
                raise AssertionError("neighborhood RPC returned bad rows")
            same += [cluster[n] == cluster[q] for r, q in enumerate(qids)
                     for n in res.ids[r] if 0 <= n < len(cluster)]
    same_rate = float(np.mean(same))

    # recall@10 of the index against the exact brute-force index
    live = gus.store.ids()
    brute = BruteIndex(gus.embedder.k_max, device=gus.device)
    brute.upsert(live, gus.embedder(gus.store.gather(live)))
    # 64 live ids from a fixed seed: the sample does not move with the stream
    qids = np.random.default_rng(1).choice(live, 64, replace=False)
    emb = gus.embedder(gus.store.gather(qids))
    bids, bd = brute.search(emb, 10)
    sids, sd = gus.index.search(emb, 10)
    ok = tot = 0
    for r in range(len(qids)):                    # as tests/test_ann.py:51-66
        kth = bd[r][bids[r] >= 0][:10].max()
        got = sd[r][sids[r] >= 0]
        tot += min(10, (bd[r] < 0).sum())
        ok += ((got <= kth) & (got < 0)).sum()
    torch.cuda.synchronize()
    counts = ops.launch_counts()

    mut = gus.mutation_timer.summary()
    qry = gus.query_timer.summary()
    shapes = dict(fq_b=16, fq_n=cfg.scann.nprobe * gus.index.slab,
                  reorder=cfg.scann.reorder, k_dims=gus.embedder.k_max,
                  sd_b=len(qids), sd_n=brute.capacity,
                  mlp=(16 * cfg.scann_nn, scorer["w0"].shape[0],
                       scorer["w0"].shape[1]))
    out = dict(n_points=n_points, bootstrapped=len(boot_ids),
               live=len(live), slab=gus.index.slab,
               capacity=gus.index.capacity, bootstrap_s=boot_s,
               first_mutation_ms=first_ms[0], first_neighbors_ms=first_ms[1],
               mutation_p50_ms=mut["p50_ms"], mutation_p99_ms=mut["p99_ms"],
               neighbors_p50_ms=qry["p50_ms"], neighbors_p99_ms=qry["p99_ms"],
               recall_at_10=float(ok / max(tot, 1)), same_cluster=same_rate,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts)
    print("[main] " + json.dumps(out))
    profile_rpcs(torch, gus, stream)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    if not same_rate > 0.7:
        raise AssertionError(f"same-cluster rate {same_rate} <= 0.7")
    return out, shapes


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    print(_card_line())
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    from repro_torch.data.synthetic import OGB_ARXIV_NODES
    dev = torch.device("cuda")
    main_path, shapes = run_main_path(torch, OGB_ARXIV_NODES, dev)
    report = check_kernels(torch, dev, shapes)

    sources = {"fused_query": ("src/repro_torch/kernels/csrc/fused_query.cu",
                               "src/repro/kernels/fused_query.py:172"),
               "sparse_dot_batched": (
                   "src/repro_torch/kernels/csrc/sparse_dot.cu",
                   "src/repro/kernels/sparse_dot.py:39"),
               "sparse_dot": ("src/repro_torch/kernels/csrc/sparse_dot.cu",
                              "src/repro/kernels/sparse_dot.py:68"),
               "scorer_mlp": ("src/repro_torch/kernels/csrc/scorer_mlp.cu",
                              "src/repro/kernels/scorer_mlp.py:33")}
    kernels = []
    for name, (source, replaces) in sources.items():
        rep = report[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=main_path["launches"][name],
            max_abs_err=rep["max_abs_err"], ms=rep["ms"],
            plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=None, shape=rep["shape"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
