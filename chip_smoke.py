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
   64 live ids drawn with a fixed seed (the brute search: the masked
   sparse_dot kernel, then topk_select; its time is on the ``[main]``
   line);
3. the index configurations, on the main path's index after its stream:
   copies of the index with ``fused=False``, ``pq_int8=True`` and both
   answer the 64 recall queries; ``fused=False`` must equal the fused
   index bitwise, and each reports recall@10;
4. the maintained graph: a second engine on the same corpus with
   ``GraphConfig(k=8)`` (the setting of ``benchmarks/graph_maintenance.py``:
   width 64; merges and reads both run the top-k kernel), bootstrapped
   with graph seeding, one set-up RPC of each kind, 20 mutation batches
   with graph maintenance and 10 fast-path neighborhood RPCs of 16 ids;
   the adjacency must be exactly symmetric and its connected components
   equal to union-find over its edges; edge recall against an offline
   rebuild at matched k on 1,024 live ids drawn with a fixed seed;
5. hold every kernel against its plain PyTorch version on the card at the
   shapes the paths reached, plus edge cases (fused_query, its int8
   instance, topk_select, both pq_score forms, both sparse_dot forms and
   sparse_rescore_topk bitwise, the signs of zeros included; scorer_mlp
   within rtol/atol 1e-6, pair_score within rtol 1e-5 / atol 1e-6), and
   time kernel, plain
   version and, for the top-k, ``torch.topk`` with CUDA events, plus each
   kernel's device time per call from ``torch.profiler`` (fused_query,
   sparse_rescore_topk and pair_score also at the graph's shapes; the
   top-k above k = 64 against the stable sort, with the route
   ``ops.topk_select`` takes there);
6. print one JSON line with each kernel's numbers, then the result line.

Phases 2-4 each zero the kernel launch counts just before they start and
read them just after; every kernel a phase runs must have launched in it.
The paths reach the exact rescore through ``sparse_rescore_topk`` and
pair scoring through ``pair_score``; the standalone kernels of the same
TPU kernels (``sparse_dot_batched``, ``scorer_mlp``) and ``pq_score``
(shared codes) have no caller on a path, so their launches are counted
around one call each in phase 5.

It imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import copy
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


def _device_ms(fn, torch) -> float:
    """Device time of one call (the sum of its kernels and copies), from
    torch.profiler over REPS calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / REPS


def _timed(torch, kernel, plain, **extra) -> dict:
    """Events ms and device ms of the kernel, events ms of its plain
    version."""
    return dict(ms=_time_ms(kernel, torch), device_ms=_device_ms(kernel, torch),
                plain_ms=_time_ms(plain, torch), **extra)


def _bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bitwise(torch, got, want) -> bool:
    """(values, indices) equal bit for bit, the signs of zeros included."""
    return (torch.equal(got[1], want[1])
            and torch.equal(got[0].view(torch.int32),
                            want[0].view(torch.int32)))


def _max_abs_err(got, want) -> float:
    same = got == want               # also covers matching infinities
    return float((got - want).abs().masked_fill(same, 0.0).max())


# ---------------------------------------------------------------- phase 5

def check_kernels(torch, dev, shapes: dict) -> dict:
    """Phase 5: every kernel against its plain version on the card, at the
    paths' shapes (``shapes``); the fused shortlist (both instances) also
    at its edge cases and the cases that cross its split into chunks, the
    f32 one at B=256 and at a 65,536-candidate slab, the top-k selection
    at its edge and split cases, in both of the reference's orders (the
    inputs come from ``repro_torch.kernels.cases``, shared with the card
    tests)."""
    from repro_torch.core.scorer import pair_layout
    from repro_torch.kernels import (cases, fused_query, ops, pq_score,
                                     scorer_mlp, sparse_dot, topk_select)
    from repro_torch.kernels.ref import DENSE, SET

    def on_card(arrays):
        return [torch.as_tensor(a).to(dev) for a in arrays]

    rng = np.random.default_rng(0)
    report = {}

    # fused_query: the main path's 16 queries x nprobe * slab candidates,
    # k = reorder, and 256 queries (graph seeding, the repair drain); a
    # slab of 65,536 (16 chunks), the edge cases and the split cases
    # (chunks of one slab); bitwise everywhere
    b, n, k = shapes["fq_b"], shapes["fq_n"], shapes["reorder"]
    fq_cases = [("main", cases.fused_query_inputs(rng, b, n, 8, 256, n // 2,
                                                  0.1), k),
                ("B=256", cases.fused_query_inputs(rng, 256, n, 8, 256,
                                                   n // 2, 0.1), k),
                ("long slab", cases.fused_query_inputs(rng, 4, 65536, 8, 256,
                                                       30000, 0.1), 128)]
    split = cases.fused_query_split_cases(rng, topk_select.CHUNK)
    fq_args = {}
    for name, inputs, k in fq_cases + cases.fused_query_edge_cases(rng) \
            + split:
        args = on_card([inputs[a] for a in cases.FQ_ORDER])
        got = fused_query.fused_query_kernel(*args, k)
        want = fused_query.fused_query_plain(*args, k)
        torch.cuda.synchronize()
        if not _bitwise(torch, got, want):
            raise AssertionError(f"fused_query differs from its plain "
                                 f"version ({name})")
        print(f"[kernels] fused_query {name}: bitwise equal")
        fq_args[name] = (args, k, _max_abs_err(got[0], want[0]))
    for name in ("main", "B=256"):
        args, k, err = fq_args[name]
        b, n, m = args[1].shape
        c = args[0].shape[2]
        # lut f32, per candidate: m code bytes, i32 id, bool valid, f32
        # bias; out: f32 + i32 per selected entry
        bound, by = _bound_ms(
            b * m * c * 4 + b * n * (m + 4 + 1 + 4) + b * k * 8,
            b * n * (m + 1) + b * n)
        report["fused_query" if name == "main" else
               f"fused_query {name}"] = dict(
            shape=f"B={b} N={n} M={m} C={c} k={k}", max_abs_err=err,
            **_timed(torch,
                     lambda: fused_query.fused_query_kernel(*args, k),
                     lambda: fused_query.fused_query_plain(*args, k)),
            bound_ms=bound, bound_by=by)
    main_k = fq_args["main"][1]

    # sparse_dot (both forms), bitwise at unit and IDF-like weights (the
    # plain version sums in the kernels' order). A sparse entry is a u32
    # index and an f32 value: the function needs 8 bytes of it (the port
    # holds indices in int64 and the kernels read their low words). No
    # path calls sparse_dot_batched (the rescore runs sparse_rescore_topk):
    # its launches are counted around its first call here. The shared
    # form also runs its edge cases (cases.sparse_dot_cases)
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
            before = fn.launches
            got = fn(*args)
            launches = fn.launches - before
            want = sparse_dot.sparse_dot_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"{name} differs (unit={unit})")
            print(f"[kernels] {name} unit={unit}: bitwise equal")
        b, kq = q_shape
        rows = int(np.prod(db_shape[:-1]))         # db rows read once
        bound, by = _bound_ms(b * kq * 8 + rows * kd * 8 + got.numel() * 4,
                              got.numel() * kq * kd)
        report[name] = dict(
            shape=f"q={q_shape} db={db_shape}",
            max_abs_err=_max_abs_err(got, want),
            **_timed(torch, lambda: fn(*args),
                     lambda: sparse_dot.sparse_dot_plain(*args)),
            bound_ms=bound, bound_by=by, launches=launches)
    for name, arrays in cases.sparse_dot_cases(rng):
        args = [None if a is None else torch.as_tensor(a).to(dev)
                for a in arrays]
        got = sparse_dot.sparse_dot(*args)
        want = sparse_dot.sparse_dot_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"sparse_dot differs ({name})")
        print(f"[kernels] sparse_dot {name}: bitwise equal")

    # sparse_rescore_topk: the shortlist's slots, slab rows, exact sparse
    # dot, mask and final top-k of the main path's search (16 queries,
    # k = scann_nn + 1) and of graph seeding (256 queries, k = probe + 1)
    # over the index's N, reorder and capacity; unit values (ties across
    # shortlist positions) and IDF-like ones, bitwise
    n, r, cap = shapes["fq_n"], shapes["reorder"], shapes["capacity"]
    for name, (b, k) in (("sparse_rescore_topk", shapes["rescore"]),
                         ("sparse_rescore_topk graph",
                          shapes["rescore_graph"])):
        for unit in (True, False):
            case = cases.rescore_inputs(rng, b, n, r, cap, kd, 40, unit)
            args = on_card([case[a] for a in cases.RESCORE_ORDER])
            got = ops.sparse_rescore_topk(*args, k)
            want = sparse_dot.sparse_rescore_topk_plain(*args, k)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(
                    got[1].view(torch.int32), want[1].view(torch.int32))):
                raise AssertionError(f"{name} differs from its plain "
                                     f"version (unit={unit})")
            print(f"[kernels] {name} B={b} r={r} k={k} unit={unit}: "
                  f"bitwise equal")
        # q, shortlist (position, score), the slot of each entry, the
        # slab rows of the live entries, out (slot, dist)
        short_slots = torch.gather(args[2], 1, args[3].long())
        live = int((torch.isfinite(args[4]) & (short_slots >= 0)).sum())
        bound, by = _bound_ms(b * kd * 8 + b * r * 8 + b * r * 4
                              + live * kd * 8 + b * k * 8,
                              live * kd * kd + b * r)
        report[name] = dict(
            shape=f"B={b} N={n} r={r} K={kd} k={k} cap={cap}",
            max_abs_err=_max_abs_err(got[1], want[1]),
            **_timed(torch, lambda: ops.sparse_rescore_topk(*args, k),
                     lambda: sparse_dot.sparse_rescore_topk_plain(*args, k)),
            bound_ms=bound, bound_by=by)

    # fused_query_int8: the same cases through the int8 table (quantised on
    # the card, as the shortlist does); bitwise everywhere
    for name, inputs, k in [fq_cases[0]] + cases.fused_query_edge_cases(rng) \
            + split:
        args = on_card([inputs[a] for a in cases.FQ_ORDER])
        table = ops.quantize_lut(args[0])
        got = fused_query.fused_query_kernel_int8(*table, *args[1:], k)
        want = fused_query.fused_query_int8_plain(*table, *args[1:], k)
        torch.cuda.synchronize()
        if not _bitwise(torch, got, want):
            raise AssertionError(f"fused_query_int8 differs from its plain "
                                 f"version ({name})")
        print(f"[kernels] fused_query_int8 {name}: bitwise equal")
        if name == "main":
            int8_args, err = (*table, *args[1:]), _max_abs_err(got[0],
                                                               want[0])
    b, n, m = int8_args[2].shape
    c = int8_args[0].shape[2]
    bound, by = _bound_ms(
        b * m * c * 1 + b * m * 4 + b * n * (m + 4 + 1 + 4) + b * main_k * 8,
        b * m * c + b * n * (m + 1) + b * n)
    report["fused_query_int8"] = dict(
        shape=f"B={b} N={n} M={m} C={c} k={main_k}", max_abs_err=err,
        **_timed(torch, lambda: fused_query.fused_query_kernel_int8(
            *int8_args, main_k), lambda: fused_query.fused_query_int8_plain(
            *int8_args, main_k)),
        bound_ms=bound, bound_by=by)

    # topk_select through ops.topk_select (the reference's order for each
    # k): the graph's merge and read shapes plus edge cases and the split
    # cases, bitwise with signed zeros; torch.topk timed beside it as the
    # library call (its order at ties is not promised lowest-index-first,
    # so it is no substitute)
    b, n, k = shapes["topk_merge"]
    topk_cases = [("merge", cases.topk_inputs(rng, b, n), k),
                  ("read", cases.topk_inputs(rng, *shapes["topk_read"][:2]),
                   shapes["topk_read"][2])] + cases.topk_edge_cases(rng) \
        + cases.topk_split_cases(topk_select.CHUNK)
    for name, scores, k in topk_cases:
        scores = torch.as_tensor(scores).to(dev)
        got = ops.topk_select(scores, k)
        want = topk_select.topk_select_plain(scores, k, signed_zeros=k > 64)
        torch.cuda.synchronize()
        if not _bitwise(torch, got, want):
            raise AssertionError(f"topk_select differs from its plain "
                                 f"version ({name})")
        print(f"[kernels] topk_select {name} {tuple(scores.shape)} k={k}: "
              f"bitwise equal")
        if name in ("merge", "read"):
            b, n = scores.shape
            bound, by = _bound_ms(b * n * 4 + b * k * 8, b * n)
            report[f"topk_select {name}"] = dict(
                shape=f"B={b} N={n} k={k}",
                max_abs_err=_max_abs_err(got[0], want[0]),
                **_timed(torch, lambda: ops.topk_select(scores, k),
                         lambda: topk_select.topk_select_plain(scores, k)),
                library_ms=_time_ms(lambda: torch.topk(scores, k), torch),
                bound_ms=bound, bound_by=by)

    # above k = 64 the reference runs lax.top_k; ops.topk_select runs the
    # kernel in that order, timed against the plain stable sort at the
    # unfused shortlist's top-reorder and at a GraphConfig(k=10) merge
    # (width 80 + 64 candidates), and held bitwise to it
    before = topk_select.topk_select.launches
    ops.topk_select(torch.zeros((1, 80), device=dev), 70)
    route = ("kernel" if topk_select.topk_select.launches > before
             else "stable sort")
    above = {"ops.topk_select route for k > 64": route}
    for name, (b, n, k) in (("shortlist", (64, 32768, 128)),
                            ("merge k=10", (1024, 144, 80))):
        scores = torch.as_tensor(cases.topk_inputs(rng, b, n)).to(dev)
        got = topk_select.topk_select(scores, k, signed_zeros=True)
        want = topk_select.topk_select_plain(scores, k, signed_zeros=True)
        torch.cuda.synchronize()
        if not _bitwise(torch, got, want):
            raise AssertionError(f"topk_select differs from its plain "
                                 f"version above k = 64 ({name})")
        bound, by = _bound_ms(b * n * 4 + b * k * 8, b * n)
        above[name] = dict(
            shape=f"B={b} N={n} k={k}", bound_ms=bound, bound_by=by,
            device_ms=_device_ms(lambda: topk_select.topk_select(
                scores, k, signed_zeros=True), torch),
            kernel_ms=_time_ms(lambda: topk_select.topk_select(
                scores, k, signed_zeros=True), torch),
            sort_ms=_time_ms(lambda: topk_select.topk_select_plain(
                scores, k, signed_zeros=True), torch),
            library_ms=_time_ms(lambda: torch.topk(scores, k), torch))
    print("[kernels] topk_select above k = 64, kernel vs its plain version "
          "(stable sort): " + json.dumps(above))

    # pq_score_batched (the fused=False shortlist's shape) and pq_score
    # (shared codes), bitwise, then every code-load path
    # (cases.pq_score_cases)
    for name, fn, b, n in (("pq_score_batched", pq_score.pq_score_batched,
                            shapes["fq_b"], shapes["fq_n"]),
                           ("pq_score", pq_score.pq_score, 16, 131072)):
        inputs = cases.fused_query_inputs(rng, b, n, 8, 256, 2, 0.0)
        lut = torch.as_tensor(inputs["lut"]).to(dev)
        codes = torch.as_tensor(inputs["codes"]).to(dev)
        if name == "pq_score":
            codes = codes[0].contiguous()
            # no path calls the shared form: its launches are counted
            # around this call
            before = pq_score.pq_score.launches
            got = fn(lut, codes)
            launches = pq_score.pq_score.launches - before
        else:
            got = fn(lut, codes)
            launches = None
        want = pq_score.pq_score_plain(lut, codes)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{name} differs from its plain version")
        print(f"[kernels] {name} B={b} N={n}: bitwise equal")
        m, c = lut.shape[1], lut.shape[2]
        bound, by = _bound_ms(b * m * c * 4 + codes.numel() + b * n * 4,
                              b * n * m)
        report[name] = dict(
            shape=f"B={b} N={n} M={m} C={c}",
            max_abs_err=_max_abs_err(got, want),
            **_timed(torch, lambda: fn(lut, codes),
                     lambda: pq_score.pq_score_plain(lut, codes)),
            bound_ms=bound, bound_by=by, launches=launches)
    for name, lut, codes, shared in cases.pq_score_cases(rng):
        lut, codes = torch.as_tensor(lut).to(dev), torch.as_tensor(codes)
        if name == "offset view":            # one byte off its buffer
            buf = torch.empty(codes.numel() + 1, dtype=torch.uint8,
                              device=dev)
            buf[1:].copy_(codes.flatten())
            codes = buf[1:].view(codes.shape)
        codes = codes.to(dev)
        fn = pq_score.pq_score if shared else pq_score.pq_score_batched
        got = fn(lut, codes)
        want = pq_score.pq_score_plain(lut, codes)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"pq_score differs ({name})")
        print(f"[kernels] pq_score {name}: bitwise equal")

    # scorer_mlp: 16 queries x 10 neighbors of arxiv pair features (no
    # path calls it: pair_score scores the pairs; launches counted here)
    b, f, h = shapes["mlp"]
    args = on_card(cases.scorer_inputs(rng, b, f, h))
    before = scorer_mlp.scorer_mlp.launches
    got = scorer_mlp.scorer_mlp(*args)
    launches = scorer_mlp.scorer_mlp.launches - before
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
        **_timed(torch, lambda: scorer_mlp.scorer_mlp(*args),
                 lambda: scorer_mlp.scorer_mlp_plain(*args)),
        bound_ms=bound, bound_by=by, launches=launches)

    # pair_score: the pair features and the MLP of the main path's 16
    # queries x 10 neighbors and of a graph seeding chunk (256 x probe
    # 16), on feature rows of the path's spec; rtol 1e-5, atol 1e-6
    spec = shapes["spec"]
    keys, layout = pair_layout(spec)
    weights = on_card(cases.scorer_inputs(rng, 1, layout.n_features, h)[1:])
    for name, (p, group) in (("pair_score", shapes["pair"]),
                             ("pair_score graph", shapes["pair_graph"])):
        fq = cases.feature_rows(rng, spec, p // group)
        fc = cases.feature_rows(rng, spec, p)
        q = on_card([fq[key] for key in keys])
        c = on_card([fc[key] for key in keys])
        got = scorer_mlp.pair_score(q, c, layout, group, *weights)
        want = scorer_mlp.pair_score_plain(q, c, layout, group, *weights)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        print(f"[kernels] {name} P={p} group={group}: max_abs_err "
              f"{_max_abs_err(got, want)!r}")
        row_bytes = sum(4 * d for d in layout.dims)
        f = layout.n_features
        per_pair = sum(9 * d if kind == DENSE else d * d if kind == SET
                       else 2 for kind, d in zip(layout.kinds, layout.dims))
        bound, by = _bound_ms(
            (p // group + p) * row_bytes + 4 * sum(w.numel() for w in weights)
            + p * 4,
            p * (per_pair + 2 * f * h + 2 * h * h + 2 * h + 3 * h + 4))
        report[name] = dict(
            shape=f"P={p} group={group} dims={layout.dims} F={f} H={h}",
            max_abs_err=_max_abs_err(got, want),
            **_timed(torch, lambda: scorer_mlp.pair_score(q, c, layout, group,
                                                          *weights),
                     lambda: scorer_mlp.pair_score_plain(q, c, layout, group,
                                                         *weights)),
            bound_ms=bound, bound_by=by)
    return report


# ---------------------------------------------------------------- phase 2

def profile_rpcs(torch, gus, stream, n: int = 4, label: str = "") -> dict:
    """Device time by kernel, device kernel launches and copies per RPC,
    and the device's idle share, over ``n`` neighborhood RPCs and ``n``
    mutation RPCs under torch.profiler (with a maintained graph: fast-path
    reads, and mutations with their graph tick)."""
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
        copies = sum(e.count for e in events
                     if e.key.startswith(("Memcpy", "Memset")))
        out[rpc] = dict(
            wall_ms_per_rpc=wall_ms / n, device_ms_per_rpc=busy_ms / n,
            device_kernels_per_rpc=(sum(e.count for e in events)
                                    - copies) / n,
            device_copies_per_rpc=copies / n,
            device_idle_share=1.0 - busy_ms / wall_ms,
            top=[(e.key[:60], e.count // n,
                  e.self_device_time_total / 1e3 / n) for e in top])
        print(f"[profile] {label}{rpc}: " + json.dumps(out[rpc]))
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
    recall = _recall_at_10((bids, bd), gus.index.search(emb, 10))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # the exact search (masked sparse dot, split top-k, the answer on the
    # host): median of 5 more calls, outside the launch counts
    brute_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        if not np.array_equal(brute.search(emb, 10)[0], bids):
            raise AssertionError("the brute search did not repeat")
        brute_ms.append((time.perf_counter() - t0) * 1e3)
    # device time of the search and of its scoring kernel on these rows
    brute_dev = (_device_ms(lambda: brute.search(emb, 10), torch),
                 _device_ms(lambda: ops.sparse_dot(
                     emb.indices, emb.values, brute.db_idx, brute.db_val,
                     valid=brute.valid), torch))

    mut = gus.mutation_timer.summary()
    qry = gus.query_timer.summary()
    # a 16-id RPC searches k = scann_nn + 1 (its own id is dropped) and
    # scores 16 x scann_nn pairs, each query row once for its neighbors
    shapes = dict(fq_b=16, fq_n=cfg.scann.nprobe * gus.index.slab,
                  reorder=cfg.scann.reorder, k_dims=gus.embedder.k_max,
                  capacity=gus.index.capacity,
                  rescore=(16, cfg.scann_nn + 1),
                  sd_b=len(qids), sd_n=brute.capacity,
                  mlp=(16 * cfg.scann_nn, scorer["w0"].shape[0],
                       scorer["w0"].shape[1]),
                  spec=data.spec, pair=(16 * cfg.scann_nn, cfg.scann_nn))
    out = dict(n_points=n_points, bootstrapped=len(boot_ids),
               live=len(live), slab=gus.index.slab,
               capacity=gus.index.capacity, bootstrap_s=boot_s,
               first_mutation_ms=first_ms[0], first_neighbors_ms=first_ms[1],
               mutation_p50_ms=mut["p50_ms"], mutation_p99_ms=mut["p99_ms"],
               neighbors_p50_ms=qry["p50_ms"], neighbors_p99_ms=qry["p99_ms"],
               recall_at_10=recall, same_cluster=same_rate,
               brute_search_ms=float(np.median(brute_ms)),
               brute_search_device_ms=brute_dev[0],
               brute_sparse_dot_device_ms=brute_dev[1],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts)
    print("[main] " + json.dumps(out))
    profile_rpcs(torch, gus, stream)
    _require_launched(counts, ("fused_query", "sparse_rescore_topk",
                               "sparse_dot", "topk_select", "pair_score"),
                      "the main path")
    if not same_rate > 0.7:
        raise AssertionError(f"same-cluster rate {same_rate} <= 0.7")
    ctx = dict(gus=gus, qids=qids, exact=(bids, bd), data=data,
               scorer=scorer, buckets=buckets)
    return out, shapes, ctx


def _require_launched(counts: dict, names, where: str) -> None:
    """Every kernel in ``names`` launched on ``where``, and neither
    standalone kernel that the fused steps replace on the paths."""
    missing = [n for n in names if counts[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on {where}: {missing}")
    stale = [n for n in ("sparse_dot_batched", "scorer_mlp") if counts[n]]
    if stale:
        raise AssertionError(f"{where} launched {stale}: the rescore and "
                             f"the pair scoring run fused")


def _recall_at_10(exact, found) -> float:
    """Tie-aware recall of ``found`` against the exact index's answer, as
    tests/test_ann.py:51-66."""
    (bids, bd), (sids, sd) = exact, found
    ok = tot = 0
    for r in range(len(bids)):
        kth = bd[r][bids[r] >= 0][:10].max()
        got = sd[r][sids[r] >= 0]
        tot += min(10, (bd[r] < 0).sum())
        ok += ((got <= kth) & (got < 0)).sum()
    return float(ok / max(tot, 1))


# ---------------------------------------------------------------- phase 3

def run_index_configs(torch, ctx: dict) -> dict:
    """Phase 3: copies of the main path's index with the other shortlist
    configurations answer the 64 recall queries (no new bootstrap)."""
    from repro_torch.kernels import ops

    gus = ctx["gus"]
    emb = gus.embedder(gus.store.gather(ctx["qids"]))
    base = gus.index.cfg
    configs = {"fused": base,
               "unfused": dataclasses.replace(base, fused=False),
               "int8": dataclasses.replace(base, pq_int8=True),
               "int8 unfused": dataclasses.replace(base, fused=False,
                                                   pq_int8=True)}
    found, search_ms = {}, {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for name, cfg in configs.items():
        index = copy.copy(gus.index)       # shares the device state
        index.cfg = cfg
        found[name] = index.search(emb, 10)
        # steady state: median of 5 more searches (results on the host)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            index.search(emb, 10)
            times.append((time.perf_counter() - t0) * 1e3)
        search_ms[name] = float(np.median(times))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for f32, other in (("fused", "unfused"), ("int8", "int8 unfused")):
        for want, got in zip(found[f32], found[other]):
            if not np.array_equal(want, got):
                raise AssertionError(f"{other} differs from {f32}")
    out = dict(recall_at_10={n: _recall_at_10(ctx["exact"], f)
                             for n, f in found.items()},
               search_p50_ms_64_queries=search_ms, launches=counts)
    print("[configs] unfused == fused and int8 unfused == int8 fused, "
          "bitwise; " + json.dumps(out))
    _require_launched(counts, ("fused_query", "fused_query_int8",
                               "pq_score_batched", "sparse_rescore_topk"),
                      "the index configurations")
    return out


# ---------------------------------------------------------------- phase 4

def _check_symmetric(store) -> None:
    """Every directed entry (r, t, w) has exactly one mirror (t, r, w), and
    no entry references a dead slot."""
    s = store.nbr_slots.cpu().numpy()
    w = store.nbr_w.cpu().numpy().view(np.int32)      # compare weight bits
    r, c = np.nonzero(s >= 0)
    t = s[r, c]
    fwd = np.stack([r, t, w[r, c]], axis=1)
    back = np.stack([t, r, w[r, c]], axis=1)
    fwd = fwd[np.lexsort(fwd.T[::-1])]
    back = back[np.lexsort(back.T[::-1])]
    if not np.array_equal(fwd, back):
        raise AssertionError("the adjacency is not symmetric")
    if len(np.unique(fwd[:, :2], axis=0)) != len(fwd):
        raise AssertionError("a row holds the same neighbor twice")
    if (store.id_of_slot[t] < 0).any():
        raise AssertionError("an entry references a dead slot")


def host_profile(torch, gus, stream, n: int) -> list:
    """Host time by Python function (cProfile, own time) over ``n``
    mutation RPCs with their graph tick: where the host spends a tick."""
    import cProfile
    import pstats

    batches = [next(stream) for _ in range(n)]
    prof = cProfile.Profile()
    prof.enable()
    for batch in batches:
        gus.mutate(batch)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:10]
    rows = [(f"{fn[0].rsplit('/', 1)[-1]}:{fn[1]}:{fn[2]}", calls // n,
             own * 1e3 / n) for fn, (_, calls, own, _, _) in top]
    print("[profile] graph host, own ms per tick: " + json.dumps(rows))
    return rows


def run_graph_path(torch, dev, ctx: dict) -> tuple[dict, dict]:
    """Phase 4: the maintained graph on the main path's corpus, scorer and
    index configuration. Returns its metrics and its top-k shapes."""
    from repro_torch.core.graph import GraphAccumulator
    from repro_torch.core.grale import top_k_per_point
    from repro_torch.core.gus import DynamicGUS, GusConfig
    from repro_torch.data.stream import MutationStream, StreamConfig
    from repro_torch.graph import GraphConfig, offline_components
    from repro_torch.kernels import ops

    k = 8
    data = ctx["data"]
    stream = MutationStream(data, StreamConfig(seed=0), bootstrap_fraction=0.6)
    boot_ids, boot_feats = stream.bootstrap()
    cfg = GusConfig(scann_nn=k, scann=ctx["gus"].cfg.scann,
                    graph=GraphConfig(k=k, capacity=2 * len(boot_ids)))
    gus = DynamicGUS(data.spec, ctx["buckets"], ctx["scorer"], cfg,
                     device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gus.bootstrap(boot_ids, boot_feats)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    seed_s = gus.graph_timer.samples_ms.pop() / 1e3
    seeded = gus.graph.describe()
    print(f"[graph] bootstrap {boot_s:.1f} s (graph seeding {seed_s:.1f} s): "
          + json.dumps(seeded))

    def mutate(batch) -> float:
        t = time.perf_counter()
        gus.mutate(batch)
        return (time.perf_counter() - t) * 1e3

    first = (mutate(next(stream)), gus.mutation_timer.samples_ms.pop(),
             gus.graph_timer.samples_ms.pop())
    gus.neighbors_of_ids(stream.query_ids(16))
    first += (gus.query_timer.samples_ms.pop(),)
    whole = [mutate(batch) for _, batch in zip(range(20), stream)]
    for _ in range(10):
        res = gus.neighbors_of_ids(stream.query_ids(16))
        if res.ids.shape != (16, k) or not np.isfinite(
                res.weights[res.ids >= 0]).all():
            raise AssertionError("fast-path RPC returned bad rows")
    if len(gus.query_timer.samples_ms) != 10:
        raise AssertionError("a fast-path RPC did not read the graph")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    _check_symmetric(gus.graph)
    t0 = time.perf_counter()
    labels = gus.graph.components()
    cc_ms = (time.perf_counter() - t0) * 1e3
    pairs, _ = gus.graph.edges()
    if labels != offline_components(pairs,
                                    np.asarray(sorted(gus.graph.slot_of))):
        raise AssertionError("graph CC differs from union-find")

    # edge recall against an offline rebuild at matched k, on 1,024 live
    # ids from a fixed seed (benchmarks/graph_maintenance.py:35-47,74-76)
    sample = np.random.default_rng(2).choice(gus.store.ids(), 1024,
                                             replace=False)
    acc = GraphAccumulator()
    for lo in range(0, sample.size, 256):
        chunk = sample[lo:lo + 256]
        acc.add_result(chunk, gus._index_neighbors_of_ids(chunk, k))
    off_pairs, off_w = acc.edges()
    keep = top_k_per_point(off_pairs, off_w, int(off_pairs.max()) + 1, k)
    offline = {tuple(p) for p in off_pairs[keep].tolist()}
    mine = {tuple(p) for p in pairs.tolist()}
    recall = len(offline & mine) / max(len(offline), 1)

    mut = gus.mutation_timer.summary()
    tick = gus.graph_timer.summary()
    qry = gus.query_timer.summary()
    desc = gus.graph.describe()
    out = dict(bootstrapped=len(boot_ids), bootstrap_s=boot_s,
               graph_seed_s=seed_s, seeded_edges=seeded["edges"],
               first_mutate_ms=first[0], first_mutation_ms=first[1],
               first_graph_tick_ms=first[2], first_fast_path_ms=first[3],
               mutation_p50_ms=mut["p50_ms"], mutation_p99_ms=mut["p99_ms"],
               graph_tick_p50_ms=tick["p50_ms"],
               graph_tick_p99_ms=tick["p99_ms"],
               mutate_with_graph_p50_ms=float(np.percentile(whole, 50)),
               mutate_with_graph_p99_ms=float(np.percentile(whole, 99)),
               fast_path_p50_ms=qry["p50_ms"], fast_path_p99_ms=qry["p99_ms"],
               nodes=desc["nodes"], edges=desc["edges"],
               capacity=desc["capacity"], width=desc["width"],
               repair_backlog=desc["repair_backlog"],
               cc_iters=gus.graph.cc_iters, cc_components=desc[
                   "cc_components"], cc_ms=cc_ms,
               edge_recall=recall, offline_edges=len(offline),
               peak_mem_gb=peak_gb, launches=counts)
    print("[graph] symmetric; CC equals union-find; " + json.dumps(out))
    out["profile"] = profile_rpcs(torch, gus, stream, n=2, label="graph ")
    out["host_top"] = host_profile(torch, gus, stream, n=2)
    _require_launched(counts, ("topk_select", "fused_query",
                               "sparse_rescore_topk", "pair_score"),
                      "the graph path")
    if not recall > 0.5:
        raise AssertionError(f"edge recall {recall} <= 0.5")
    # seeding chunks of 256 ids search k = probe + 1 and score 256 x probe
    probe = gus.graph.cfg.probe_k()
    shapes = dict(merge=(1024, gus.graph.width + 64, gus.graph.width),
                  read=(16, gus.graph.width, k), rescore=(256, probe + 1),
                  pair=(256 * probe, probe))
    return out, shapes


SOURCES = {  # kernel -> (CUDA source, TPU kernel it replaces, path)
    "fused_query": ("src/repro_torch/kernels/csrc/fused_query.cu",
                    "src/repro/kernels/fused_query.py:172", "main"),
    "fused_query_int8": ("src/repro_torch/kernels/csrc/fused_query.cu",
                         "src/repro/kernels/fused_query.py:203", "configs"),
    "sparse_rescore_topk": ("src/repro_torch/kernels/csrc/sparse_dot.cu",
                            "src/repro/kernels/sparse_dot.py:39", "main"),
    "sparse_dot_batched": ("src/repro_torch/kernels/csrc/sparse_dot.cu",
                           "src/repro/kernels/sparse_dot.py:39",
                           "kernel check"),
    "sparse_dot": ("src/repro_torch/kernels/csrc/sparse_dot.cu",
                   "src/repro/kernels/sparse_dot.py:68", "main"),
    "pair_score": ("src/repro_torch/kernels/csrc/scorer_mlp.cu",
                   "src/repro/kernels/scorer_mlp.py:33", "main"),
    "scorer_mlp": ("src/repro_torch/kernels/csrc/scorer_mlp.cu",
                   "src/repro/kernels/scorer_mlp.py:33", "kernel check"),
    "topk_select": ("src/repro_torch/kernels/csrc/topk_select.cu",
                    "src/repro/kernels/topk_select.py:42", "graph"),
    "pq_score_batched": ("src/repro_torch/kernels/csrc/pq_score.cu",
                         "src/repro/kernels/pq_score.py:37", "configs"),
    "pq_score": ("src/repro_torch/kernels/csrc/pq_score.cu",
                 "src/repro/kernels/pq_score.py:63", "kernel check"),
}


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
    main_path, shapes, ctx = run_main_path(torch, OGB_ARXIV_NODES, dev)
    configs = run_index_configs(torch, ctx)
    graph, graph_shapes = run_graph_path(torch, dev, ctx)
    del ctx
    shapes.update(topk_merge=graph_shapes["merge"],
                  topk_read=graph_shapes["read"],
                  rescore_graph=graph_shapes["rescore"],
                  pair_graph=graph_shapes["pair"])
    report = check_kernels(torch, dev, shapes)

    path_counts = {"main": main_path["launches"],
                   "configs": configs["launches"],
                   "graph": graph["launches"]}
    kernels = []
    for name, (source, replaces, path) in SOURCES.items():
        # topk_select's line carries the merge shape, the larger of its two
        rep = report["topk_select merge" if name == "topk_select" else name]
        launches = (rep["launches"] if path == "kernel check"
                    else path_counts[path][name])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, launches_in=path,
            launches_graph=path_counts["graph"][name],
            max_abs_err=rep["max_abs_err"], ms=rep["ms"],
            device_ms=rep["device_ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
            library_ms=rep.get("library_ms"), shape=rep["shape"]))
    for extra in ("topk_select read", "fused_query B=256",
                  "sparse_rescore_topk graph", "pair_score graph"):
        print(f"[kernels] {extra}: " + json.dumps(report[extra]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
