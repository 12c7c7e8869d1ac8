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
6. the serving plane (run after phase 4), through ``launch/serve.py``'s
   ``build_engine`` at the main path's size and config: a pipelined
   ``GusEngine`` with one replica and a synchronous twin from the same
   seed take 24 batches (16 insert-only, which fuse, then 8 of the
   default mix); index arrays and 64 neighborhoods must be equal bit for
   bit and fewer than 24 windows encoded; the device's idle share over
   the 16 insert-only batches on each path; 16 more batches on the
   pipelined engine, each timed from its submit to the hand-off that
   makes it visible on both members (freshness); 10 warm 16-id engine
   queries, then a scripted straggler (one hedge, answered as the replica
   answers), a dead primary (fail-over), 3 batches it misses and its
   revival (catch-up of those 3, bit for bit the replica); a snapshot, 4 more batches and two
   recoveries (the live store, equal to each other bit for bit, recall@10
   within 0.02 of the live engine's); phase 4's graph engine snapshotted
   and restored with ``staleness_bound=2`` (no re-seed), 20 batches
   through ``MutationPipeline`` with the lag at most 2 after every
   hand-off and the published view equal to the graph, exactly
   symmetric, after ``flush``; 200 requests (3 queries to 1 mutation)
   through ``Frontend`` with queues small enough to shed: bounds held,
   every accepted request answered once, the registry reconciled;
6s. the sharded backend (run after phase 6): ``launch/serve.py``'s
   ``build_engine("arxiv", 169,343, backend="sharded", shards=4)``, four
   index shards on the one card (664 partitions, 166 a shard, every local
   partition probed: a shard's shortlist scans 166 x slab candidates), the
   main path's traffic (set-up RPCs timed apart, 20 batches of 64, a 16-id
   RPC after every other one), recall@10 on 64 live ids against the brute
   oracle and the same-cluster rate; ``compact()`` mid-stream with those
   64 neighborhoods bit for bit unchanged; ``resplit(1.0)`` moving points
   with every live id kept and recall within 0.02; on the same slabs
   ``fused=False`` == fused bit for bit, ``pq_int8=True``'s recall, and
   the "hier" merge on a 2x2 grid equal to the flat merge up to ties
   (counted); it records the shape of every fused shortlist, rescore,
   pair scoring, unfused pq-score and top-k and brute search it makes,
   and phase 5 checks the kernels there;
5m. the multi-modal plane: (a) ``products-multimodal``, an
   ogbn-products-like corpus (dense 100, a co-purchase set of 16) at
   169,343 points, 60% bootstrapped, with launch/serve.py's buckets and
   index (k_max 14) and ``MultiModalConfig(sparse_k=10, d_sketch=64,
   idf_size=512, filter_percent=1.0, reload_every=5)``: the main path's
   traffic (set-up RPCs timed apart, 20 batches of 64, a 16-id
   neighborhood RPC after every other one) through the two-stage
   retrieval, whose exact distances run sparse_dot_batched and whose
   rescore runs pair_score; same-cluster rate > 0.7; (b) the
   Android-Security time-to-flag (``benchmarks/torch_time_to_flag.py``)
   on the card, ratio >= 2.0;
5. hold every kernel against its plain PyTorch version on the card at the
   shapes the paths reached, plus edge cases (fused_query, its int8
   instance, topk_select, both pq_score forms, both sparse_dot forms and
   sparse_rescore_topk bitwise, the signs of zeros included; scorer_mlp
   within rtol/atol 1e-6, pair_score within rtol 1e-5 / atol 1e-6), and
   time kernel, plain
   version and, for the top-k, ``torch.topk`` with CUDA events, plus each
   kernel's device time per call from ``torch.profiler`` (the mean over
   the profiled calls whose device records came back whole; fused_query,
   sparse_rescore_topk and pair_score also at the graph's shapes and the
   products-multimodal RPC's; the top-k above k = 64 against the stable
   sort, with the route ``ops.topk_select`` takes there). Phase 5m
   records the shape of every two-stage retrieval and brute search it
   makes, and phase 5 checks sparse_dot_batched, pair_score, the masked
   sparse_dot and topk_select at each of them; phase 6 records the shape
   of every fused shortlist, rescore, pair scoring, top-k and brute
   search it makes, and phase 5 checks those kernels at each of them, as
   it does at phase 6s's (the fused shortlist, the rescore and the pair
   scoring of its 16-id RPC timed beside their bounds: the ``sharded``
   rows);
7. the dry-run's GUS cells (run after phase 5): ``launch/dryrun.py``'s
   ``run_gus_cell`` at the default, full-size cell (``gus_serve_100m``:
   4,096 partitions x 8,192 slots, half filled, K = 16, d = 128, M = 16;
   4,096 queries, 65,536 mutations) on the one card: the 16x16 mesh's
   query step (flat and hier), mutate and delete steps and the 2x16x16
   mesh's query step, each checked (the first 64 queries bit for bit the
   same step's on CPU copies of every shard, at least 90% of the
   distances finite and nonzero; the 65,536 mutated rows read back from
   their reported sites, cursors moved by what each partition received,
   no other slot changed; the delete's bits cleared exactly) and timed,
   one ``[dryrun]`` line per record (step ms, temp_bytes, peak GB); it
   records the fused shortlist's and the rescore's shapes, and phase 5's
   checks run there just after it (the ``dryrun`` rows);
8. the LM tower (run after phase 7; ``run_lm_path``): qwen3-8b at its
   published widths and full depth (36 layers, d 4,096, 32/8 heads,
   vocab 151,936; 8.19 B params, 16.38 GB in bf16, random from a seed)
   through ``serve/serve_step.py``: (a) in bf16, a prefill of 8 prompts
   of 512 tokens, the same 8 served one decode step per prompt token and
   then 32 greedy tokens, twice (tokens bit for bit), each prompt step's
   logits within the bound below of the prefill's, one decode step
   profiled, and a 3,000-token prefill (the flash path, padded) against
   the same prompt through full attention; (b) the same weights in f32:
   decode against teacher-forced within 1e-3 on 2 requests of 128
   tokens, and the gap of (a)'s prefill to the f32 logits, whose largest
   value times ``DECODE_GAP_FACTOR`` bounds (a)'s decode-vs-prefill gap
   and its flash-vs-full gap. It must launch none of the GUS kernels;
9. the LM tower's other families (run after phase 8;
   ``run_lm_families_path``; ``[lm-families]`` lines): qwen2-moe-a2.7b
   (24 layers, 60 experts top-4 + 4 shared; 14.3 B params, 28.6 GB in
   bf16), xlstm-1.3b (48 layers, 42 mLSTM + 6 sLSTM) and whisper-tiny
   (1,500 frames) whole, and jamba-1.5-large-398b cut to one interleave
   group (8 of 72 layers) and 8 of its 16 experts at its published widths
   (25.9 B params), each through ``serve/serve_step.py``: (a) in bf16, a
   prefill of 8 x 512 tokens at the published capacity factor (the MoE
   drops counted), whisper's ``encode_prefill`` of 8 x 1,500 frames, the
   prompts' first 64 tokens served by decode steps then 32 greedy tokens,
   twice (tokens bit for bit), each prompt step against a no-drop prefill
   (capacity E / k), one decode step profiled; xlstm's 3,000-token prompt
   through the chunkwise mLSTM against the parallel form, with the sLSTM
   loop's host time; (b) the same weights in f32 (jamba's a layer at a
   time): the bf16 prefill's gap to f32 bounds (a)'s gaps as in phase 8,
   and f32 decode against teacher-forced within 1e-3 (jamba at its
   ``reduced_config``). It must launch none of the GUS kernels;
10. training (run after phase 9; ``run_train_path``; ``[train]`` lines):
   (a) qwen3-8b at full width and depth (8.19 B params) in bf16 with bf16
   moments (the one cut: f32 moments do not fit beside the params and
   grads), its 2 microbatches, 6 AdamW steps on one 8 x 512 batch of
   ``MarkovTokens``: the memory estimate from the ``meta`` device beside
   the card's, the loss finite and falling, the pre-clip grad norm in 2
   microbatches within 1% of one microbatch's, one step profiled, the
   sliced AdamW update bit for bit the whole-leaf formula, step wall,
   tokens/s, model-FLOP share and peak GB; (b) qwen2-moe, qwen2-vl,
   xlstm, whisper and jamba at ``reduced_config``, 3 steps each with the
   loss falling; (c) ``launch/train.py --reduced`` for qwen3-8b, 4 steps
   straight equal to 2, ``--resume`` and 2 more, bit for bit; (d) the
   compressed data-parallel step (int8 codes, error feedback) at 2
   shards, the loss falling. It must launch none of the GUS kernels;
11. the dry-run's architecture cells (run after phase 10;
   ``run_dryrun_arch_path``; ``[dryrun-arch]`` lines): ``launch/
   dryrun.py``'s sweep over every arch x shape x both meshes (80
   records, 16 of them the non-applicable long_500k skips): every live
   cell sized on the meta device (per-device memory from the sharding
   specs, the step's flops and bytes, the collectives, the 1- and
   2-group probes), and the cells whose plan fits 85% of the card
   (``ARCH_CARD_CELLS``: xlstm-1.3b x long_500k, whisper-tiny x
   decode_32k) run whole on the card at their own shape with
   ``check=True`` (the first rows against the same step on CPU copies);
   one JSON line of the records. It fails on an ``error`` record, a
   named cell that did not run on the card or a failed check, and must
   launch none of the GUS kernels;
12. print one JSON line with each kernel's numbers (with its launches on
   each path, ``launches_serve`` the serving phase's,
   ``launches_sharded`` the sharded phase's, ``launches_dryrun`` the
   dry-run's, ``launches_lm`` the LM tower's (phases 8 and 9),
   ``launches_train`` the training phase's and ``launches_arch`` the
   architecture cells', all 0), then the result line.

Phases 2-4, 6, 6s, 5m, 7, 8, 9, 10 and 11 each zero the kernel launch counts just
before they start and read them just after; every kernel a phase runs
must have launched in it. The index paths reach the exact rescore through
``sparse_rescore_topk`` and pair scoring through ``pair_score``, so
phases 2-4 and 6 must not launch the standalone ``sparse_dot_batched`` or
``scorer_mlp`` (nor must phases 6s and 7); the multi-modal phase runs
``sparse_dot_batched`` itself
and must not launch ``scorer_mlp``. ``scorer_mlp`` and ``pq_score``
(shared codes) have no caller on a path, so their launches are counted
around one call each in phase 5. Phase 5 also holds the top-k sizes past
the split's old limits (k > 4,096 on long rows, shortlists over 8,192,
the fused shortlist at k = 4,097) bitwise against the plain versions.

It imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
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
WINDOWS = 5                      # profiler windows a device time may take


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


# the kernel of torch.cuda._sleep, launched between profiled calls
SEPARATOR = "spin_kernel"


def _device_profile(fn, torch) -> tuple[float, int]:
    """Device time of one call (the sum of its kernels and copies), from
    torch.profiler after a warm-up, and the number of calls it averages.
    In a window of REPS calls a separator kernel runs before each call
    and after the last, so on the device's timeline the records between
    two separators are one call's. The profiler drops a window's first
    device records, more as the process ages (PERF.md section 7), so only
    the calls whose records came back whole count; windows repeat, up to
    WINDOWS, until REPS // 2 calls have, and none raises."""
    whole = [sum(us for _, us in call) for call in _profile_calls(fn, torch)]
    return sum(whole) / len(whole) / 1e3, len(whole)


def _profile_calls(fn, torch, reps: int = REPS) -> list:
    """``_device_profile``'s windows of ``reps`` calls: the device records
    (name, microseconds) of each call whose records came back whole (one
    list per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    whole = []
    for _ in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.cuda._sleep(1)
                fn()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        whole += _whole_calls([e for e in prof.events()
                               if e.device_type == DeviceType.CUDA])
        if len(whole) >= reps // 2:
            break
    if not whole:
        raise AssertionError(f"torch.profiler kept no call's device records "
                             f"in {WINDOWS} windows of {reps}")
    return whole


def _whole_calls(records) -> list:
    """The device records (name, microseconds) of each call whose records
    came back whole: the records between two separators on the device's
    timeline, where their count is the window's most common non-zero one
    ([] if none)."""
    calls, call = [], None
    for e in sorted(records, key=lambda e: e.time_range.start):
        if SEPARATOR in e.name:
            if call is not None:
                calls.append(call)
            call = []
        elif call is not None:
            call.append((e.name, e.time_range.elapsed_us()))
    counts = collections.Counter(len(c) for c in calls if c)
    if not counts:
        return []
    usual = counts.most_common(1)[0][0]
    return [c for c in calls if len(c) == usual]


def _timed(torch, kernel, plain, **extra) -> dict:
    """Events ms and device ms of the kernel (with the number of profiled
    calls the device ms averages), events ms of its plain version."""
    ms = _time_ms(kernel, torch)
    device_ms, device_calls = _device_profile(kernel, torch)
    return dict(ms=ms, device_ms=device_ms, device_calls=device_calls,
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

def _fq_row(torch, args, k: int, err: float) -> dict:
    """The f32 fused shortlist's report row on ``args`` (``FQ_ORDER``):
    kernel, device and plain times beside its bound."""
    from repro_torch.kernels import fused_query
    b, n, m = args[1].shape
    c = args[0].shape[2]
    # lut f32, per candidate: m code bytes, i32 id, bool valid, f32 bias;
    # out: f32 + i32 per selected entry
    bound, by = _bound_ms(b * m * c * 4 + b * n * (m + 4 + 1 + 4) + b * k * 8,
                          b * n * (m + 1) + b * n)
    return dict(shape=f"B={b} N={n} M={m} C={c} k={k}", max_abs_err=err,
                **_timed(torch,
                         lambda: fused_query.fused_query_kernel(*args, k),
                         lambda: fused_query.fused_query_plain(*args, k)),
                bound_ms=bound, bound_by=by)


def _check_rescore(torch, rng, on_card, b, n, r, cap, kdim, k, unit):
    """The rescore against its plain version, bitwise, on inputs from
    ``cases.rescore_inputs``: unit values (ties across shortlist
    positions) or IDF-like ones. Returns (inputs, got, want)."""
    from repro_torch.kernels import cases, ops, sparse_dot
    case = cases.rescore_inputs(rng, b, n, r, cap, kdim, 40, unit)
    args = on_card([case[a] for a in cases.RESCORE_ORDER])
    got = ops.sparse_rescore_topk(*args, k)
    want = sparse_dot.sparse_rescore_topk_plain(*args, k)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(
            got[1].view(torch.int32), want[1].view(torch.int32))):
        raise AssertionError(f"sparse_rescore_topk differs from its "
                             f"plain version (B={b} N={n} r={r} "
                             f"K={kdim} k={k} unit={unit})")
    print(f"[kernels] sparse_rescore_topk B={b} N={n} r={r} K={kdim} "
          f"k={k} unit={unit}: bitwise equal")
    return args, got, want


def _rescore_row(torch, args, got, want, k) -> dict:
    """The rescore's report row: kernel, device and plain times beside its
    bound."""
    from repro_torch.kernels import ops, sparse_dot
    # q, shortlist (position, score), the slot of each entry, the slab
    # rows of the live entries, out (slot, dist)
    b, kdim = args[0].shape
    r = args[3].shape[1]
    short_slots = torch.gather(args[2], 1, args[3].long())
    live = int((torch.isfinite(args[4]) & (short_slots >= 0)).sum())
    bound, by = _bound_ms(b * kdim * 8 + b * r * 8 + b * r * 4
                          + live * kdim * 8 + b * k * 8,
                          live * kdim * kdim + b * r)
    return dict(
        shape=f"B={b} N={args[2].shape[1]} r={r} K={kdim} k={k} "
              f"cap={args[5].shape[0]}",
        max_abs_err=_max_abs_err(got[1], want[1]),
        **_timed(torch, lambda: ops.sparse_rescore_topk(*args, k),
                 lambda: sparse_dot.sparse_rescore_topk_plain(*args, k)),
        bound_ms=bound, bound_by=by)


def check_kernels(torch, dev, shapes: dict) -> dict:
    """Phase 5: every kernel against its plain version on the card, at the
    paths' shapes (``shapes``); the fused shortlist (both instances) also
    at its edge cases and the cases that cross its split into chunks, the
    f32 one at B=256 and at a 65,536-candidate slab, the top-k selection
    at its edge and split cases, in both of the reference's orders, and
    the kernels of the multi-modal phase at every shape it recorded (the
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
        report["fused_query" if name == "main" else
               f"fused_query {name}"] = _fq_row(torch, *fq_args[name])
    main_k = fq_args["main"][1]

    # sparse_dot (both forms), bitwise at unit and IDF-like weights (the
    # plain version sums in the kernels' order). A sparse entry is a u32
    # index and an f32 value: the function needs 8 bytes of it (the port
    # holds indices in int64 and the kernels read their low words).
    # sparse_dot_batched at the multi-modal path's shape (16 queries x
    # r_max candidates of K = 14) and at the rescore's (which the index
    # path runs fused, as sparse_rescore_topk). The shared form also runs
    # its edge cases (cases.sparse_dot_cases)
    kd = shapes["k_dims"]
    mm_b, mm_r, mm_k = shapes["mm"]
    forms = {"sparse_dot_batched": (
                 sparse_dot.sparse_dot_batched, 40, (mm_b, mm_k),
                 (mm_b, mm_r, mm_k)),
             "sparse_dot_batched rescore shape": (
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

    # every shape the multi-modal phase gave: sparse_dot_batched at each
    # two-stage retrieval's (rows, r_max, K) (its pair_score below), and
    # each brute search of the time-to-flag and of the serving phase's
    # recall oracle, the masked shared sparse_dot over the index's slots
    # and the top-k in lax.top_k's order; unit values (ties) and IDF-like
    # ones, bitwise
    for _, rows, r_max, kdim in shapes["mm_calls"]:
        for unit in (True, False):
            args = on_card([*cases.sparse_rows(rng, (rows, kdim), 40, unit),
                            *cases.sparse_rows(rng, (rows, r_max, kdim), 40,
                                               unit)])
            got = sparse_dot.sparse_dot_batched(*args)
            want = sparse_dot.sparse_dot_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"sparse_dot_batched differs at "
                                     f"{(rows, r_max, kdim)} (unit={unit})")
        print(f"[kernels] sparse_dot_batched q=({rows}, {kdim}) "
              f"db=({rows}, {r_max}, {kdim}): bitwise equal")
    for b, kdim, slots, k in shapes["brute_calls"]:
        for unit in (True, False):
            args = on_card([*cases.sparse_rows(rng, (b, kdim), 40, unit),
                            *cases.sparse_rows(rng, (slots, kdim), 40, unit),
                            rng.random(slots) < 0.7])
            got = sparse_dot.sparse_dot(*args)
            want = sparse_dot.sparse_dot_plain(*args)
            top = topk_select.topk_select(got, k, signed_zeros=True)
            top_want = topk_select.topk_select_plain(want, k,
                                                     signed_zeros=True)
            torch.cuda.synchronize()
            if not (torch.equal(got.view(torch.int32), want.view(torch.int32))
                    and _bitwise(torch, top, top_want)):
                raise AssertionError(f"the brute search's kernels differ at "
                                     f"{(b, kdim, slots, k)} (unit={unit})")
        print(f"[kernels] brute search B={b} K={kdim} slots={slots} k={k}: "
              f"sparse_dot and topk_select bitwise equal")

    # sparse_rescore_topk: the shortlist's slots, slab rows, exact sparse
    # dot, mask and final top-k of the main path's search (16 queries,
    # k = scann_nn + 1) and of graph seeding (256 queries, k = probe + 1)
    # over the index's N, reorder and capacity, and of the multi-modal
    # phase's products index (its N, capacity and K = k_max); unit values
    # (ties across shortlist positions) and IDF-like ones, bitwise
    check_rescore = functools.partial(_check_rescore, torch, rng, on_card)
    rescore_row = functools.partial(_rescore_row, torch)

    index = (shapes["fq_n"], shapes["reorder"], shapes["capacity"], kd)
    (b, k), (b_graph, k_graph) = shapes["rescore"], shapes["rescore_graph"]
    for name, (b, n, r, cap, kdim, k) in (
            ("sparse_rescore_topk", (b, *index, k)),
            ("sparse_rescore_topk graph", (b_graph, *index, k_graph)),
            ("sparse_rescore_topk multimodal", shapes["mm_rescore"])):
        for unit in (True, False):
            res = check_rescore(b, n, r, cap, kdim, k, unit)
        report[name] = rescore_row(*res, k)

    # Part A: past the split's old limits. Sparse_rescore_topk on
    # shortlists of 8,193 and 16,384 (the keys route: a [B, r] scratch,
    # then the split top-k) at the main path's B, slab and capacity over
    # N = 32,768, k = 5,000 (pairwise merge) and k = scann_nn + 1 (halving
    # merge; timed); bitwise
    part_a = {}
    for r in (8193, 16384):
        for k in (5000, shapes["rescore"][1]):
            res = check_rescore(shapes["fq_b"], 32768, r, shapes["capacity"],
                                kd, k, True)
        part_a[f"sparse_rescore_topk r={r}"] = rescore_row(*res, k)

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

    # Part A: k past half a chunk on long rows (the pairwise merge), in
    # both signed-zero orders, bitwise (cases.topk_long_k_cases); the
    # first two timed in lax.top_k's order beside torch.topk; then the
    # fused shortlist at k = 4,097 over 32,768 candidates (its pairwise
    # merge and dedup kernel), both tables
    for name, scores, k in cases.topk_long_k_cases(rng):
        scores = torch.as_tensor(scores).to(dev)
        for signed in (False, True):
            got = topk_select.topk_select(scores, k, signed_zeros=signed)
            want = topk_select.topk_select_plain(scores, k,
                                                 signed_zeros=signed)
            torch.cuda.synchronize()
            if not _bitwise(torch, got, want):
                raise AssertionError(f"topk_select differs from its plain "
                                     f"version ({name}, signed={signed})")
        print(f"[kernels] topk_select {name}: bitwise equal in both orders")
        if name in ("B=4 N=32768 k=4097", "B=2 N=131072 k=16384"):
            b, n = scores.shape
            bound, by = _bound_ms(b * n * 4 + b * k * 8, b * n)
            part_a[f"topk_select {name}"] = dict(
                shape=name, max_abs_err=_max_abs_err(got[0], want[0]),
                **_timed(torch, lambda: topk_select.topk_select(
                    scores, k, signed_zeros=True),
                    lambda: topk_select.topk_select_plain(
                        scores, k, signed_zeros=True)),
                library_ms=_time_ms(lambda: torch.topk(scores, k), torch),
                bound_ms=bound, bound_by=by)
    inputs = cases.fused_query_inputs(rng, shapes["fq_b"], 32768, 8, 256,
                                      16384, 0.1)
    args = on_card([inputs[a] for a in cases.FQ_ORDER])
    k = 4097
    for int8 in (False, True):
        table = ops.quantize_lut(args[0]) if int8 else (args[0],)
        kernel, plain = ((fused_query.fused_query_kernel_int8,
                          fused_query.fused_query_int8_plain) if int8 else
                         (fused_query.fused_query_kernel,
                          fused_query.fused_query_plain))
        got = kernel(*table, *args[1:], k)
        want = plain(*table, *args[1:], k)
        torch.cuda.synchronize()
        if not _bitwise(torch, got, want):
            raise AssertionError(f"fused_query (int8={int8}) differs from "
                                 f"its plain version at k = {k}")
        print(f"[kernels] fused_query int8={int8} N=32768 k={k}: bitwise "
              f"equal")
    b, n, m = args[1].shape
    bound, by = _bound_ms(b * m * 256 * 4 + b * n * (m + 4 + 1 + 4)
                          + b * k * 8, b * n * (m + 1) + b * n)
    part_a[f"fused_query k={k}"] = dict(
        shape=f"B={b} N={n} M={m} C=256 k={k}",
        max_abs_err=_max_abs_err(got[0], want[0]),
        **_timed(torch, lambda: fused_query.fused_query_kernel(*args, k),
                 lambda: fused_query.fused_query_plain(*args, k)),
        bound_ms=bound, bound_by=by)
    print("[kernels] part A: " + json.dumps(part_a))

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
            device_ms=_device_profile(lambda: topk_select.topk_select(
                scores, k, signed_zeros=True), torch)[0],
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
    # queries x 10 neighbors, of a graph seeding chunk (256 x probe 16)
    # and of the products-multimodal RPC (16 x r_max), on feature rows of
    # each path's spec, timed; then every two-stage retrieval's shape of
    # the multi-modal phase (shapes["mm_calls"]); rtol 1e-5, atol 1e-6
    def check_pairs(spec, p, group):
        keys, layout = pair_layout(spec)
        weights = on_card(cases.scorer_inputs(rng, 1, layout.n_features,
                                              h)[1:])
        fq = cases.feature_rows(rng, spec, p // group)
        fc = cases.feature_rows(rng, spec, p)
        q = on_card([fq[key] for key in keys])
        c = on_card([fc[key] for key in keys])
        got = scorer_mlp.pair_score(q, c, layout, group, *weights)
        want = scorer_mlp.pair_score_plain(q, c, layout, group, *weights)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        print(f"[kernels] pair_score P={p} group={group} dims={layout.dims}: "
              f"max_abs_err {_max_abs_err(got, want)!r}")
        return q, c, layout, weights, got, want

    def pair_row(spec, p, group):
        q, c, layout, weights, got, want = check_pairs(spec, p, group)
        row_bytes = sum(4 * d for d in layout.dims)
        f = layout.n_features
        per_pair = sum(9 * d if kind == DENSE else d * d if kind == SET
                       else 2 for kind, d in zip(layout.kinds, layout.dims))
        bound, by = _bound_ms(
            (p // group + p) * row_bytes + 4 * sum(w.numel() for w in weights)
            + p * 4,
            p * (per_pair + 2 * f * h + 2 * h * h + 2 * h + 3 * h + 4))
        return dict(
            shape=f"P={p} group={group} dims={layout.dims} F={f} H={h}",
            max_abs_err=_max_abs_err(got, want),
            **_timed(torch, lambda: scorer_mlp.pair_score(q, c, layout, group,
                                                          *weights),
                     lambda: scorer_mlp.pair_score_plain(q, c, layout, group,
                                                         *weights)),
            bound_ms=bound, bound_by=by)

    for name, spec, (p, group) in (
            ("pair_score", shapes["spec"], shapes["pair"]),
            ("pair_score graph", shapes["spec"], shapes["pair_graph"]),
            ("pair_score multimodal", shapes["mm_spec"], shapes["mm_pair"])):
        report[name] = pair_row(spec, p, group)
    for spec, rows, r_max, _ in shapes["mm_calls"]:
        check_pairs(spec, rows * r_max, r_max)
    check_serving_shapes(torch, rng, on_card, shapes, check_rescore,
                         check_pairs)
    report.update(check_sharded_shapes(torch, rng, on_card, shapes,
                                       check_rescore, rescore_row, pair_row))
    return report


def check_serving_shapes(torch, rng, on_card, shapes: dict, check_rescore,
                         check_pairs) -> None:
    """Phase 5, the serving phase's shapes (``shapes["serve_calls"]``,
    its brute searches are among ``shapes["brute_calls"]``): the fused
    shortlist of every query batch it ran (the engine pads 1-4 front-end
    rows to 1, 2 or 4; 64 ids in its bitwise and recall checks), the
    rescore and the pair scoring after each, and every top-k of the
    graph's merges and reads under the maintenance plane; bitwise but for
    pair_score (rtol 1e-5, atol 1e-6). ``check_rescore`` and
    ``check_pairs`` are ``check_kernels``' own checks."""
    from repro_torch.core.scorer import pair_layout
    from repro_torch.kernels import cases, fused_query, ops, topk_select

    calls = shapes["serve_calls"]
    for b, n, m, c, k, int8 in sorted(calls["fq"]):
        inputs = cases.fused_query_inputs(rng, b, n, m, c, max(n // 2, 1),
                                          0.1)
        args = on_card([inputs[a] for a in cases.FQ_ORDER])
        if int8:
            table = ops.quantize_lut(args[0])
            got = fused_query.fused_query_kernel_int8(*table, *args[1:], k)
            want = fused_query.fused_query_int8_plain(*table, *args[1:], k)
        else:
            got = fused_query.fused_query_kernel(*args, k)
            want = fused_query.fused_query_plain(*args, k)
        torch.cuda.synchronize()
        if not _bitwise(torch, got, want):
            raise AssertionError(f"fused_query differs from its plain "
                                 f"version at the serving phase's B={b} "
                                 f"N={n} M={m} C={c} k={k} int8={int8}")
        print(f"[kernels] fused_query serve B={b} N={n} M={m} C={c} k={k} "
              f"int8={int8}: bitwise equal")
    for b, n, r, cap, kq, kd, k in sorted(calls["rescore"]):
        if kq != kd:
            raise AssertionError(f"the serving phase's rescore had Kq={kq} "
                                 f"against Kd={kd}: no case for it")
        for unit in (True, False):
            check_rescore(b, n, r, cap, kd, k, unit)
    specs = {pair_layout(spec)[1]: spec
             for spec in (shapes["spec"], shapes["mm_spec"])}
    for layout, p, group in sorted(calls["pair"], key=lambda c: c[1:]):
        if layout not in specs:
            raise AssertionError(f"the serving phase scored pairs of an "
                                 f"unknown layout {layout}")
        check_pairs(specs[layout], p, group)
    for b, n, k in sorted(calls["topk"]):
        for ties in (False, True):
            scores = on_card([cases.topk_inputs(rng, b, n, ties)])[0]
            got = ops.topk_select(scores, k)
            want = topk_select.topk_select_plain(scores, k,
                                                 signed_zeros=k > 64)
            torch.cuda.synchronize()
            if not _bitwise(torch, got, want):
                raise AssertionError(f"topk_select differs from its plain "
                                     f"version at the serving phase's "
                                     f"B={b} N={n} k={k} (ties={ties})")
    print(f"[kernels] topk_select at the serving phase's "
          f"{len(calls['topk'])} shapes, with and without ties: bitwise "
          f"equal")


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
    brute_dev = (_device_profile(lambda: brute.search(emb, 10), torch)[0],
                 _device_profile(lambda: ops.sparse_dot(
                     emb.indices, emb.values, brute.db_idx, brute.db_val,
                     valid=brute.valid), torch)[0])

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


def _require_launched(counts: dict, names, where: str,
                      forbidden=("sparse_dot_batched", "scorer_mlp")) -> None:
    """Every kernel in ``names`` launched on ``where``, and no standalone
    kernel in ``forbidden`` that the fused steps replace on the path (the
    multi-modal path runs sparse_dot_batched itself)."""
    missing = [n for n in names if counts[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on {where}: {missing}")
    stale = [n for n in forbidden if counts[n]]
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


def host_profile(torch, call, items: list, label: str) -> list:
    """Host time by Python function (cProfile, own time) over ``call`` of
    each of ``items``: where the host spends an RPC."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for item in items:
        call(item)
    torch.cuda.synchronize()
    prof.disable()
    n = len(items)
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:10]
    rows = [(f"{fn[0].rsplit('/', 1)[-1]}:{fn[1]}:{fn[2]}", calls // n,
             own * 1e3 / n) for fn, (_, calls, own, _, _) in top]
    print(f"[profile] {label} host, own ms per call: " + json.dumps(rows))
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
    out["host_top"] = host_profile(torch, gus.mutate,
                                   [next(stream) for _ in range(2)],
                                   "graph mutate with tick")
    _require_launched(counts, ("topk_select", "fused_query",
                               "sparse_rescore_topk", "pair_score"),
                      "the graph path")
    if not recall > 0.5:
        raise AssertionError(f"edge recall {recall} <= 0.5")
    ctx["graph"] = (gus, stream)           # phase 6 restores this engine
    # seeding chunks of 256 ids search k = probe + 1 and score 256 x probe
    probe = gus.graph.cfg.probe_k()
    shapes = dict(merge=(1024, gus.graph.width + 64, gus.graph.width),
                  read=(16, gus.graph.width, k), rescore=(256, probe + 1),
                  pair=(256 * probe, probe))
    return out, shapes


# ---------------------------------------------------------------- phase 6

_INDEX_ARRAYS = ("sp_idx", "sp_val", "members", "codes_list", "valid_list")


def _same_index(torch, a, b) -> bool:
    """Two scann engines hold the same index, bit for bit: the slab
    arrays on the card and the host id maps."""
    return a.index.slot_of == b.index.slot_of and all(
        torch.equal(getattr(a.index, n), getattr(b.index, n))
        for n in _INDEX_ARRAYS)


def _same_answer(x, y) -> bool:
    return all(np.array_equal(getattr(x, f), getattr(y, f))
               for f in ("ids", "weights", "distances"))


def _device_idle(torch, fn) -> dict:
    """Wall ms, device busy ms (kernels and copies) and the device's idle
    share of one call of ``fn``, under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    return dict(wall_ms=wall_ms, device_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms)


def _brute_oracle(torch, gus, qids):
    """The exact index over ``gus``'s live corpus, and its top-10 for
    ``qids`` (the recall oracle of phase 2)."""
    from repro_torch.ann.brute import BruteIndex
    live = gus.store.ids()
    brute = BruteIndex(gus.embedder.k_max, device=gus.device)
    brute.upsert(live, gus.embedder(gus.store.gather(live)))
    return brute.search(gus.embedder(gus.store.gather(qids)), 10)


def _recall(gus, qids, exact) -> float:
    emb = gus.embedder(gus.store.gather(qids))
    return _recall_at_10(exact, gus.index.search(emb, 10))


def run_serving_path(torch, n_points: int, dev, graph: tuple) -> dict:
    """Phase 6: the serving plane through its entry points. (1) a
    pipelined engine with one replica from ``launch/serve.py::
    build_engine`` and a synchronous twin from the same seed take 24
    batches (16 insert-only, which fuse, then 8 of the default mix) and
    must hold the same index bit for bit; (2) warm queries, a scripted
    straggler (a hedge), a dead primary (fail-over), its revival
    (catch-up); (3) snapshot, 4 more batches, two recoveries that must
    agree bit for bit and keep recall within 0.02; (4) phase 4's graph
    engine restored with ``staleness_bound=2`` and 20 pipelined batches
    through the maintenance plane; (5) 200 requests through the
    front-end. ``graph`` is phase 4's (engine, stream). Returns the
    metrics, with ``calls``: every shape the phase gave the fused
    shortlist, the rescore, the pair scorer, the top-k and the brute
    search, for phase 5 to check the kernels at."""
    from repro_torch.ann.brute import BruteIndex
    from repro_torch.core.gus import DynamicGUS
    from repro_torch.core.maintenance import MaintenanceConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import BUCKETS, build_engine
    from repro_torch.serve import (EngineConfig, FaultInjector, Frontend,
                                   FrontendConfig, MutationPipeline)
    primary_key = FaultInjector.PRIMARY

    # the shapes of this phase's kernel calls, recorded until the launch
    # counts are read
    calls = {name: set() for name in ("fq", "rescore", "pair", "topk",
                                      "brute")}
    recording = contextlib.ExitStack()
    for owner, name, key, into in (
            (ops, "pq_score_dedup_topk", _fq_key, calls["fq"]),
            (ops, "sparse_rescore_topk", _rescore_key, calls["rescore"]),
            (ops, "pair_score", _pair_key, calls["pair"]),
            (ops, "topk_select", _topk_key, calls["topk"]),
            (BruteIndex, "search", _brute_key, calls["brute"])):
        recording.enter_context(_record_calls(owner, name, key, into))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out = {}

    # 1. the pipelined engine, its replica and the synchronous twin
    t0 = time.perf_counter()
    engine, stream, _ = build_engine("arxiv", n_points, replicas=1,
                                     engine_cfg=EngineConfig(pipeline=True),
                                     device=dev)
    twin, _, _ = build_engine("arxiv", n_points, device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    mix = stream.cfg
    stream.cfg = dataclasses.replace(mix, insert_frac=1.0, update_frac=0.0)
    batches = [next(stream) for _ in range(16)]
    stream.cfg = mix
    batches += [next(stream) for _ in range(8)]

    def feed(eng, items):
        for batch in items:
            eng.submit_mutations(batch)

    # the device's idle share over the 16 insert-only batches on each
    # path, the pipelined one flushed (two whole windows of 8)
    idle = {"pipelined": _device_idle(torch, lambda: (
                feed(engine, batches[:16]), engine.flush())),
            "sync": _device_idle(torch, lambda: feed(twin, batches[:16]))}
    for eng in (engine, twin):
        feed(eng, batches[16:])
    engine.flush()
    pipe = engine.pipelines[0]
    qids = np.random.default_rng(3).choice(twin.gus.store.ids(), 64,
                                           replace=False)
    if pipe.windows >= 24:
        raise AssertionError(f"no window fused: {pipe.windows} windows")
    for member in (engine.gus, engine.replicas[0]):
        if not _same_index(torch, member, twin.gus):
            raise AssertionError("pipelined index differs from sync")
        if not _same_answer(member._index_neighbors_of_ids(qids, 10),
                            twin.gus._index_neighbors_of_ids(qids, 10)):
            raise AssertionError("pipelined answers differ from sync")
    desc = pipe.describe()
    out.update(
        windows=pipe.windows, submitted=pipe.submitted,
        encode_p50_ms=desc["encode"]["p50_ms"],
        encode_p99_ms=desc["encode"]["p99_ms"],
        handoff_p50_ms=desc["handoff"]["p50_ms"],
        handoff_p99_ms=desc["handoff"]["p99_ms"],
        submit_p50_ms=engine.freshness.summary()["p50_ms"],
        submit_p99_ms=engine.freshness.summary()["p99_ms"],
        sync_freshness_p50_ms=twin.freshness.summary()["p50_ms"],
        sync_freshness_p99_ms=twin.freshness.summary()["p99_ms"],
        idle=idle)

    # freshness of the pipelined path: 16 more batches of the default mix,
    # each timed from its submit to the end of the hand-off that applies
    # it on both members (a read sees it from then on without a flush;
    # the last window's hand-off is the flush's). engine_freshness_ms
    # above is the submit call's wall, the staging alone
    members = (engine.gus, engine.replicas[0])
    base = [m.seq_applied for m in members]
    t_submit, visible_ms = [], []

    def mark():
        now = time.perf_counter()
        done = min(m.seq_applied - b for m, b in zip(members, base))
        while len(visible_ms) < done:
            visible_ms.append((now - t_submit[len(visible_ms)]) * 1e3)

    for _ in range(16):
        batch = next(stream)
        t_submit.append(time.perf_counter())
        engine.submit_mutations(batch)
        mark()
    engine.flush()
    mark()
    if len(visible_ms) != 16:
        raise AssertionError(f"{len(visible_ms)} of 16 batches visible "
                             f"after flush")
    out.update(freshness_p50_ms=float(np.percentile(visible_ms, 50)),
               freshness_p99_ms=float(np.percentile(visible_ms, 99)))
    print(f"[serve] pipelined (primary + replica) == sync, bitwise: index "
          f"arrays and 64 neighborhoods; {out['windows']} windows for 24 "
          f"batches; build {out['build_s']:.1f} s; " + json.dumps(
              {k: v for k, v in out.items() if k != "build_s"}))
    del twin
    torch.cuda.empty_cache()

    # 2. queries, a hedge, fail-over and catch-up
    feats = [stream.query_features(16) for _ in range(12)]
    engine.query(feats[0])                     # set-up: loads modules
    engine.serving.reset()
    for f in feats[1:11]:
        res = engine.query(f)
        if res.ids.shape != (16, 10) or not np.isfinite(
                res.weights[res.ids >= 0]).all():
            raise AssertionError("engine query returned bad rows")
    warm = engine.serving.summary()
    faults = engine.faults
    faults.slow(primary_key, 10 * engine.cfg.hedge_ms)
    hedged = engine.query(feats[11])
    faults.clear_slow(primary_key)
    want = engine.replicas[0].neighbors(feats[11])
    if engine.hedged < 1 or not _same_answer(hedged, want):
        raise AssertionError("the straggler was not hedged to the replica")
    faults.kill(primary_key)
    if not _same_answer(engine.query(feats[11]), want) or \
            engine.failovers < 1:
        raise AssertionError("the dead primary did not fail over")
    feed(engine, [next(stream) for _ in range(3)])
    if engine.primary.applied_seq != engine.seq - 3:
        raise AssertionError("the dead primary applied a batch")
    faults.revive(primary_key)
    engine.query(feats[11])
    ev = engine.obs.events.last("catch_up")
    if (engine.primary.applied_seq != engine.seq or ev is None
            or ev["batches"] != 3 or ev["rebootstrapped"]):
        raise AssertionError("catch-up did not replay the log suffix")
    if not _same_index(torch, engine.gus, engine.replicas[0]):
        raise AssertionError("the caught-up primary differs from the "
                             "replica")
    out.update(hedges=engine.hedged, failovers=engine.failovers,
               catchups=engine.obs.registry.get(
                   "engine_catchups_total").value,
               serving_p50_ms=warm["p50_ms"], serving_p99_ms=warm["p99_ms"],
               serving_n=warm["n"])
    print("[serve] hedge to the replica, fail-over, catch-up of 3 batches; "
          + json.dumps({k: out[k] for k in (
              "hedges", "failovers", "catchups", "serving_p50_ms",
              "serving_p99_ms")}))

    # 3. snapshot, 4 more batches, recovery twice
    engine.snapshot()
    feed(engine, [next(stream) for _ in range(4)])
    engine.flush()
    live = engine.gus

    def fresh():
        return DynamicGUS(live.spec, BUCKETS, live.scorer_params, live.cfg,
                          device=dev)

    t0 = time.perf_counter()
    rec = engine.recover(fresh())
    torch.cuda.synchronize()
    out["recovery_s"] = time.perf_counter() - t0
    rec2 = engine.recover(fresh())
    want_store = live.store.snapshot_state()
    got_store = rec.gus.store.snapshot_state()
    if not np.array_equal(got_store["ids"], want_store["ids"]) or not all(
            np.array_equal(got_store["features"][k], v)
            for k, v in want_store["features"].items()):
        raise AssertionError("the recovered store differs from the live one")
    if not _same_index(torch, rec.gus, rec2.gus) or not _same_answer(
            rec.gus._index_neighbors_of_ids(qids, 10),
            rec2.gus._index_neighbors_of_ids(qids, 10)):
        raise AssertionError("two recoveries from one snapshot differ")
    del rec2
    rq = np.random.default_rng(1).choice(live.store.ids(), 64,
                                         replace=False)
    exact = _brute_oracle(torch, live, rq)
    out.update(recall_live=_recall(live, rq, exact),
               recall_recovered=_recall(rec.gus, rq, exact))
    print(f"[serve] recovered in {out['recovery_s']:.1f} s (restore, "
          f"retrain, replay of 4 batches); store equal to the live one; a "
          f"second recovery equal bit for bit; recall@10 "
          f"{out['recall_recovered']:.4f} vs live {out['recall_live']:.4f}")
    if abs(out["recall_recovered"] - out["recall_live"]) > 0.02:
        raise AssertionError("recovered recall differs by more than 0.02")
    del rec
    torch.cuda.empty_cache()

    # 4. the maintenance plane: phase 4's graph restored, staleness bound 2
    graph_gus, gstream = graph
    snap = graph_gus.snapshot_state()
    cfg = dataclasses.replace(graph_gus.cfg, maintenance=MaintenanceConfig(
        staleness_bound=2))
    plane = DynamicGUS(graph_gus.spec, BUCKETS, graph_gus.scorer_params, cfg,
                       device=dev)
    t0 = time.perf_counter()
    plane.restore_state(snap)
    torch.cuda.synchronize()
    out["graph_restore_s"] = time.perf_counter() - t0
    del snap
    gpipe = MutationPipeline(plane)
    submit_ms, lags = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        gpipe.submit(next(gstream))
        submit_ms.append((time.perf_counter() - t0) * 1e3)
        lags.append(gpipe.worker.lag())
        if lags[-1] > 2:
            raise AssertionError(f"plane lag {lags[-1]} > 2")
    gpipe.flush()
    view = plane.graph.view()
    if (view.seq != plane.seq_applied or view.slot_of != plane.graph.slot_of
            or not torch.equal(view.nbr_slots, plane.graph.nbr_slots)
            or not torch.equal(view.nbr_w, plane.graph.nbr_w)):
        raise AssertionError("the published view differs from the graph")
    _check_symmetric(plane.graph)
    gdesc = gpipe.describe()
    tick = plane.graph_timer.summary()
    out["plane"] = dict(
        bound=2, window=gpipe.window_size(), windows=gpipe.windows,
        max_lag=max(lags), ticks=gdesc["maintenance"]["ticks"],
        handoff_p50_ms=gdesc["handoff"]["p50_ms"],
        handoff_p99_ms=gdesc["handoff"]["p99_ms"],
        tick_p50_ms=gpipe.obs.registry.get(
            "maintenance_tick_ms").summary()["p50_ms"],
        graph_tick_p50_ms=tick["p50_ms"],
        submit_p50_ms=float(np.percentile(submit_ms, 50)),
        submit_p99_ms=float(np.percentile(submit_ms, 99)),
        restore_s=out.pop("graph_restore_s"))
    print("[serve] maintenance plane: lag <= 2 after every hand-off, the "
          "view equals the graph after flush, symmetric; "
          + json.dumps(out["plane"]))
    del plane, gpipe
    torch.cuda.empty_cache()

    # 5. the front-end: about 3 queries to 1 mutation, queues small enough
    # to shed
    fcfg = FrontendConfig(query_queue=8, mutate_queue=2, query_dispatch=4,
                          mutate_dispatch=1)
    fe = Frontend(engine, fcfg)
    rng = np.random.default_rng(5)
    issued = {"query": 0, "mutate": 0}
    accepted, terminal = [], []
    while sum(issued.values()) < 200:
        op = rng.integers(5)
        if op == 4:
            terminal += fe.step()
        else:
            kind = "mutate" if op == 3 else "query"
            r = (fe.submit_mutation(next(stream)) if kind == "mutate"
                 else fe.submit_query(stream.query_features(1), k=10))
            issued[kind] += 1
            if r.status == "accepted":
                accepted.append(r.rid)
            elif not r.terminal:
                raise AssertionError(f"request {r.rid}: {r.status}")
        if (fe.queue_depth("query") > fcfg.query_queue
                or fe.queue_depth("mutate") > fcfg.mutate_queue):
            raise AssertionError("a front-end queue passed its bound")
    terminal += fe.drain()
    done = [r.rid for r in terminal if r.status in ("ok", "error")]
    if sorted(done) != sorted(accepted):
        raise AssertionError("an accepted request got no single answer")
    reg = fe.obs.registry
    for kind in ("query", "mutate"):
        if (fe.accepted[kind] + fe.shed[kind] != issued[kind]
                or reg.get(f"frontend_completed_{kind}_total").value
                + (fe.errors if kind == "query" else 0)
                != fe.accepted[kind]):
            raise AssertionError(f"front-end {kind} counts do not "
                                 "reconcile")
    shed = fe.shed["query"] + fe.shed["mutate"]
    if not shed or (reg.get("frontend_shed_capacity_total").value
                    + reg.get("frontend_shed_backpressure_total").value
                    != shed):
        raise AssertionError("front-end sheds do not reconcile")
    fdesc = fe.describe()
    out["frontend"] = dict(
        issued=issued, accepted=fdesc["accepted"], shed=fdesc["shed"],
        completed=fdesc["completed"], errors=fdesc["errors"],
        steps=fdesc["steps"], high_water=fdesc["queue_high_water"],
        query_p50_ms=fdesc["query_latency"]["p50_ms"],
        query_p99_ms=fdesc["query_latency"]["p99_ms"],
        mutate_p50_ms=fdesc["mutate_latency"]["p50_ms"])
    print("[frontend] queues within bounds, every accepted request "
          "answered once, the registry reconciles; "
          + json.dumps(out["frontend"]))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    recording.close()
    out.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts)
    print(f"[serve] peak {out['peak_mem_gb']:.2f} GB; launches "
          + json.dumps(counts) + "; shapes recorded: " + json.dumps(
              {name: len(keys) for name, keys in calls.items()}))
    _require_launched(counts, ("fused_query", "sparse_rescore_topk",
                               "pair_score", "topk_select"),
                      "the serving phase")
    del engine
    torch.cuda.empty_cache()
    out["calls"] = calls
    return out


# ---------------------------------------------------------------- phase 6s

def _pq_key(lut, codes, *, quantized=False):
    """(B, N, M, C, int8) of an ops.pq_scores call."""
    return (*codes.shape, lut.shape[2], quantized)


def _tie_diffs(want, got) -> int:
    """Positions where two answers' ids differ: each must sit in a group
    of equal distance (a tie) and the distances must agree bit for bit.
    Returns how many positions differ."""
    (w_ids, w_d), (g_ids, g_d) = want, got
    if not np.array_equal(w_d.view(np.int32), g_d.view(np.int32)):
        raise AssertionError("the hier merge's distances differ")
    diff = 0
    for r in range(w_ids.shape[0]):
        for d in np.unique(w_d[r]):
            sel = w_d[r] == d
            if set(w_ids[r][sel]) != set(g_ids[r][sel]):
                raise AssertionError(f"the hier merge's ids differ outside "
                                     f"a tie (row {r})")
        diff += int((w_ids[r] != g_ids[r]).sum())
    return diff


def run_sharded_path(torch, n_points: int, dev) -> dict:
    """Phase 6s: the sharded backend through ``launch/serve.py::
    build_engine("arxiv", n_points, backend="sharded", shards=4)``, every
    shard on the one card. (a) bootstrap, one set-up RPC of each kind, 20
    default-mix batches with a 16-id neighborhood RPC after every other
    one; recall@10 of 64 live ids against the brute oracle, same-cluster
    rate; (b) ``compact()`` mid-stream: those 64 neighborhoods bit for
    bit the same; (c) ``resplit(1.0)`` moves points, every live id keeps
    its rows, recall within 0.02; (d) on the same slabs, ``fused=False``
    == fused bit for bit, ``pq_int8=True``'s recall, and the "hier" merge
    on a 2x2 grid with the flat merge's answer up to ties. Returns the
    metrics, with ``calls``: every shape the phase gave the fused
    shortlist, the rescore, the pair scorer, the unfused shortlist's
    pq-score and top-k, and the brute search, for phase 5."""
    from repro_torch.ann import sharded as sharded_module
    from repro_torch.ann.brute import BruteIndex
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_gus_mesh
    from repro_torch.launch.serve import build_engine

    calls = {name: set() for name in ("fq", "rescore", "pair", "topk", "pq",
                                      "brute")}
    recording = contextlib.ExitStack()
    for owner, name, key, into in (
            (ops, "pq_score_dedup_topk", _fq_key, calls["fq"]),
            (ops, "sparse_rescore_topk", _rescore_key, calls["rescore"]),
            (ops, "pair_score", _pair_key, calls["pair"]),
            (ops, "pq_scores", _pq_key, calls["pq"]),
            (sharded_module, "topk_select", _topk_key, calls["topk"]),
            (BruteIndex, "search", _brute_key, calls["brute"])):
        recording.enter_context(_record_calls(owner, name, key, into))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    engine, stream, cluster = build_engine("arxiv", n_points,
                                           backend="sharded", shards=4,
                                           device=dev)
    gus = engine.gus
    index = gus.index
    torch.cuda.synchronize()
    out = dict(n_points=n_points, shards=index.cfg.n_shards,
               partitions=index.cfg.n_partitions, slab=index.slab,
               candidates_per_shard=index.cfg.n_partitions
               // index.cfg.n_shards * index.slab,
               devices=sorted({str(d) for d in index.mesh.devices}),
               build_s=time.perf_counter() - t0)
    print(f"[sharded] engine built in {out['build_s']:.1f} s: "
          + json.dumps(index.occupancy()))

    # (a) the traffic of the main path
    gus.mutate(next(stream))
    gus.neighbors_of_ids(stream.query_ids(16))
    out.update(first_mutation_ms=gus.mutation_timer.samples_ms.pop(),
               first_neighbors_ms=gus.query_timer.samples_ms.pop())
    same = []
    for i, batch in zip(range(20), stream):
        gus.mutate(batch)
        if i % 2 == 1:
            qids = stream.query_ids(16)
            res = gus.neighbors_of_ids(qids)
            if res.ids.shape != (16, 10) or not np.isfinite(
                    res.weights[res.ids >= 0]).all():
                raise AssertionError("sharded RPC returned bad rows")
            same += [cluster[n] == cluster[q] for r, q in enumerate(qids)
                     for n in res.ids[r] if 0 <= n < len(cluster)]
    mut, qry = gus.mutation_timer.summary(), gus.query_timer.summary()
    out.update(mutation_p50_ms=mut["p50_ms"], mutation_p99_ms=mut["p99_ms"],
               neighbors_p50_ms=qry["p50_ms"], neighbors_p99_ms=qry["p99_ms"],
               same_cluster=float(np.mean(same)))
    qids = np.random.default_rng(1).choice(gus.store.ids(), 64,
                                           replace=False)
    exact = _brute_oracle(torch, gus, qids)
    out["recall_at_10"] = _recall(gus, qids, exact)

    # (b) compaction mid-stream is invisible to the 64 neighborhoods
    before = gus.neighbors_of_ids(qids)
    t0 = time.perf_counter()
    out["compaction"] = index.compact()
    out["compact_ms"] = (time.perf_counter() - t0) * 1e3
    if not _same_answer(before, gus.neighbors_of_ids(qids)):
        raise AssertionError("compaction changed a neighborhood")

    # (c) a forced re-split
    imbalance = index.occupancy()["shard_imbalance"]
    t0 = time.perf_counter()
    moved = index.resplit(imbalance=1.0)
    out.update(resplit_moved=moved, resplit_s=time.perf_counter() - t0,
               imbalance_before=imbalance,
               imbalance_after=index.occupancy()["shard_imbalance"])
    if moved < 1:
        raise AssertionError("resplit(1.0) moved no point")
    if set(index.row_of) != set(gus.store.ids().tolist()):
        raise AssertionError("a live id lost its rows in the re-split")
    out["recall_after_resplit"] = _recall(gus, qids, exact)
    if abs(out["recall_after_resplit"] - out["recall_at_10"]) > 0.02:
        raise AssertionError(f"recall moved by the re-split: "
                             f"{out['recall_at_10']} -> "
                             f"{out['recall_after_resplit']}")

    # (d) the other shortlist forms and the hier merge, same slabs
    emb = gus.embedder(gus.store.gather(qids))
    base = index.cfg
    found = {}
    for name, cfg in (("fused", base),
                      ("unfused", dataclasses.replace(base, fused=False)),
                      ("int8", dataclasses.replace(base, pq_int8=True)),
                      ("hier", dataclasses.replace(base, merge="hier"))):
        clone = copy.copy(index)           # shares the shard tensors
        clone.cfg = cfg
        clone._query_steps = {}
        clone.query_load = index.query_load.copy()
        if name == "hier":
            clone.mesh = make_gus_mesh(4, two_level=True, device=dev)
        found[name] = clone.search(emb, 10)
    for want, got in zip(found["fused"], found["unfused"]):
        if not np.array_equal(want.view(np.int32), got.view(np.int32)):
            raise AssertionError("fused=False differs from the fused "
                                 "shortlist")
    out["hier_tie_diffs"] = _tie_diffs(found["fused"], found["hier"])
    out["recall_by_form"] = {n: _recall_at_10(exact, f)
                             for n, f in found.items()}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    recording.close()
    out.update(phase_s=time.perf_counter() - t_phase,
               occupancy=index.occupancy(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts)
    out["profile"] = profile_rpcs(torch, gus, stream, label="sharded ")
    print("[sharded] fused=False == fused bitwise; compaction bit-identical; "
          + json.dumps({k: v for k, v in out.items() if k != "profile"})
          + "; shapes recorded: " + json.dumps(
              {name: len(keys) for name, keys in calls.items()}))
    _require_launched(counts, ("fused_query", "fused_query_int8",
                               "sparse_rescore_topk", "pair_score",
                               "pq_score_batched", "topk_select"),
                      "the sharded backend")
    if not out["same_cluster"] > 0.7:
        raise AssertionError(f"sharded same-cluster rate "
                             f"{out['same_cluster']} <= 0.7")
    del engine, gus, index, found
    torch.cuda.empty_cache()
    out["calls"] = calls
    return out


def check_sharded_shapes(torch, rng, on_card, shapes: dict, check_rescore,
                         rescore_row, pair_row) -> dict:
    """Phase 5, the sharded phase's shapes (``shapes["sharded_calls"]``;
    its brute searches are among ``shapes["brute_calls"]``): the fused
    shortlist (both tables) of every batch it ran over a shard's
    N = C_loc x slab candidates, the rescore and the pair scoring after
    each, and the unfused shortlist's pq-score and top-k (lax.top_k's
    order); bitwise but for pair_score (rtol 1e-5, atol 1e-6). The
    16-query RPC's shapes are timed: the report's ``sharded`` rows."""
    from repro_torch.core.scorer import pair_layout
    from repro_torch.kernels import (cases, fused_query, ops, pq_score,
                                     topk_select)

    calls = shapes["sharded_calls"]
    report = {}
    for b, n, m, c, k, int8 in sorted(calls["fq"]):
        inputs = cases.fused_query_inputs(rng, b, n, m, c, n // 2, 0.1)
        args = on_card([inputs[a] for a in cases.FQ_ORDER])
        table = ops.quantize_lut(args[0]) if int8 else (args[0],)
        kernel, plain = ((fused_query.fused_query_kernel_int8,
                          fused_query.fused_query_int8_plain) if int8 else
                         (fused_query.fused_query_kernel,
                          fused_query.fused_query_plain))
        got = kernel(*table, *args[1:], k)
        want = plain(*table, *args[1:], k)
        torch.cuda.synchronize()
        if not _bitwise(torch, got, want):
            raise AssertionError(f"fused_query differs from its plain "
                                 f"version at the sharded phase's B={b} "
                                 f"N={n} k={k} int8={int8}")
        print(f"[kernels] fused_query sharded B={b} N={n} M={m} C={c} "
              f"k={k} int8={int8}: bitwise equal")
        if b == 16 and not int8:
            report["fused_query sharded"] = _fq_row(
                torch, args, k, _max_abs_err(got[0], want[0]))
        del args, got, want
    for b, n, r, cap, kq, kd, k in sorted(calls["rescore"]):
        if kq != kd:
            raise AssertionError(f"the sharded phase's rescore had Kq={kq} "
                                 f"against Kd={kd}: no case for it")
        for unit in (True, False):
            res = check_rescore(b, n, r, cap, kd, k, unit)
        if b == 16:
            report["sparse_rescore_topk sharded"] = rescore_row(*res, k)
        del res
    specs = {pair_layout(shapes["spec"])[1]: shapes["spec"]}
    for layout, p, group in sorted(calls["pair"], key=lambda c: c[1:]):
        if layout not in specs:
            raise AssertionError(f"the sharded phase scored pairs of an "
                                 f"unknown layout {layout}")
        row = pair_row(specs[layout], p, group)
        if p == 16 * group:
            report["pair_score sharded"] = row
    for b, n, m, c, int8 in sorted(calls["pq"]):
        inputs = cases.fused_query_inputs(rng, b, n, m, c, 2, 0.0)
        lut, codes = on_card([inputs["lut"], inputs["codes"]])
        got = pq_score.pq_score_batched(lut, codes)
        want = pq_score.pq_score_plain(lut, codes)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"pq_score_batched differs at the sharded "
                                 f"phase's B={b} N={n}")
        print(f"[kernels] pq_score_batched sharded B={b} N={n}: bitwise "
              f"equal")
        del lut, codes, got, want
    for b, n, k in sorted(calls["topk"]):
        scores = on_card([cases.topk_inputs(rng, b, n)])[0]
        got = topk_select.topk_select(scores, k, signed_zeros=True)
        want = topk_select.topk_select_plain(scores, k, signed_zeros=True)
        torch.cuda.synchronize()
        if not _bitwise(torch, got, want):
            raise AssertionError(f"topk_select differs at the sharded "
                                 f"phase's B={b} N={n} k={k}")
        print(f"[kernels] topk_select sharded B={b} N={n} k={k} (lax.top_k "
              f"order): bitwise equal")
    return report


# ---------------------------------------------------------------- phase 7

# (multi_pod, op, merge) of each dry-run cell phase 7 runs
DRYRUN_CELLS = ((False, "query", "flat"), (False, "query", "hier"),
                (False, "mutate", "flat"), (False, "delete", "flat"),
                (True, "query", "flat"))


def _card_calls(key):
    """``key`` of a call whose first argument (a tensor) lies on the card;
    None for the CPU twin's calls (the dry-run's query check)."""
    def on_card(*args, **kwargs):
        return (key(*args, **kwargs) if args[0].device.type == "cuda"
                else None)
    return on_card


def run_dryrun_path(torch, dev, runs: int = 3, **size) -> dict:
    """Phase 7: the dry-run's GUS cells through ``launch/dryrun.py::
    run_gus_cell`` at the default, full-size cell (4,096 partitions x
    8,192 slots, 4,096 queries, 65,536 mutations, K = 16, M = 16) on the
    one card: on the 16x16 mesh the query step (flat and hier), the
    mutate and the delete step, on the 2x16x16 mesh the query step. Each
    runs with ``check=True`` (the query's first 64 answers bit for bit
    those of the same step on CPU copies of every shard, the mutate's
    rows read back from their reported sites with nothing else changed,
    the delete's bits cleared exactly), then ``runs`` timed steps; each
    record goes to a temporary directory. ``size`` (``n_partitions``,
    ``slab``) cuts the cell for a rehearsal on the CPU. Returns the
    records, with
    ``calls``: every shape the card's steps gave the fused shortlist and
    the rescore, for phase 5."""
    import os
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    calls = {"fq": set(), "rescore": set()}
    recording = contextlib.ExitStack()
    for name, key, into in (
            ("pq_score_dedup_topk", _fq_key, calls["fq"]),
            ("sparse_rescore_topk", _rescore_key, calls["rescore"])):
        recording.enter_context(_record_calls(ops, name, _card_calls(key),
                                              into))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    records = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for multi_pod, op, merge in DRYRUN_CELLS:
            rec = dryrun.run_gus_cell(multi_pod, out_dir, op=op, merge=merge,
                                      device=dev, runs=runs, check=True,
                                      **size)
            records[f"{rec['kind']}_{rec['mesh']}"] = rec
            torch.cuda.empty_cache()
        written = sorted(os.listdir(out_dir))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    recording.close()
    for into in calls.values():
        into.discard(None)
    if written != sorted(f"{name}.json" for name in records):
        raise AssertionError(f"the dry-run wrote {written}")
    out = dict(records=records, phase_s=time.perf_counter() - t0,
               launches=counts, calls=calls)
    print("[dryrun] records: " + json.dumps(records))
    print(f"[dryrun] phase 7 in {out['phase_s']:.1f} s; shapes recorded: "
          + json.dumps({name: sorted(keys) for name, keys in calls.items()}))
    _require_launched(counts, ("fused_query", "sparse_rescore_topk"),
                      "the dry-run's cells")
    return out


def check_dryrun_shapes(torch, dev, calls: dict) -> dict:
    """Phase 5 at the dry-run's shapes (``calls``, phase 7's), run after
    phase 7: the fused shortlist (B = 4,096 queries, N = 16,384
    candidates, M = 16, k = 200) and the rescore (r = 200, K = 16,
    k = 100, slab rows 131,072 on the 16x16 mesh and 65,536 on the
    2x16x16) bitwise against their plain versions, each timed beside its
    bound: the ``dryrun`` rows."""
    from repro_torch.kernels import cases, fused_query

    def on_card(arrays):
        return [torch.as_tensor(a).to(dev) for a in arrays]

    rng = np.random.default_rng(7)
    check_rescore = functools.partial(_check_rescore, torch, rng, on_card)
    report = {}
    for b, n, m, c, k, int8 in sorted(calls["fq"]):
        if int8:
            raise AssertionError("the dry-run's cells ran the int8 table")
        inputs = cases.fused_query_inputs(rng, b, n, m, c, n // 2, 0.1)
        args = on_card([inputs[a] for a in cases.FQ_ORDER])
        del inputs
        got = fused_query.fused_query_kernel(*args, k)
        want = fused_query.fused_query_plain(*args, k)
        torch.cuda.synchronize()
        if not _bitwise(torch, got, want):
            raise AssertionError(f"fused_query differs from its plain "
                                 f"version at the dry-run's B={b} N={n} "
                                 f"M={m} k={k}")
        print(f"[kernels] fused_query dryrun B={b} N={n} M={m} C={c} k={k}: "
              f"bitwise equal")
        report["fused_query dryrun"] = _fq_row(torch, args, k,
                                               _max_abs_err(got[0], want[0]))
        del args, got, want
    for b, n, r, cap, kq, kd, k in sorted(calls["rescore"], reverse=True):
        if kq != kd:
            raise AssertionError(f"the dry-run's rescore had Kq={kq} "
                                 f"against Kd={kd}: no case for it")
        for unit in (True, False):
            res = check_rescore(b, n, r, cap, kd, k, unit)
        report[f"sparse_rescore_topk dryrun slab {cap}"] = _rescore_row(
            torch, *res, k)
        del res
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------- phase 5m

@contextlib.contextmanager
def _record_calls(owner, name: str, key, into: set):
    """Inside the block, every call of ``owner.name`` also adds
    ``key(*args)`` to ``into``: the shapes a path gives a kernel's caller,
    for phase 5 to check the kernel at."""
    orig = getattr(owner, name)

    def wrapped(*args, **kwargs):
        into.add(key(*args, **kwargs))
        return orig(*args, **kwargs)

    setattr(owner, name, wrapped)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _two_stage_key(gus, features, k, exclude_ids=None, emb=None,
                   buckets=None):
    """(spec, query rows, r_max, K) of a two_stage_neighbors call: the
    union is the dense search's k (+1 with exclusions) and sparse_k."""
    rows = len(next(iter(features.values())))
    return (gus.spec, rows,
            k + (exclude_ids is not None) + gus.cfg.multimodal.sparse_k,
            gus.embedder.k_max)


def _brute_key(index, emb, k):
    """(queries, K, slots, k) of a BruteIndex.search call."""
    return (*emb.indices.shape, index.capacity, min(k, index.capacity))


def _fq_key(lut, codes, ids, k, *, valid=None, bias=None, quantized=False):
    """(B, N, M, C, k, int8) of an ops.pq_score_dedup_topk call."""
    return (*codes.shape, lut.shape[2], k, quantized)


def _rescore_key(q_idx, q_val, flat_slots, short_pos, short_scores, sp_idx,
                 sp_val, k):
    """(B, N, r, capacity, Kq, Kd, k) of an ops.sparse_rescore_topk call."""
    return (*flat_slots.shape, short_pos.shape[1], sp_idx.shape[0],
            q_idx.shape[1], sp_idx.shape[1], k)


def _pair_key(params, q_fields, c_fields, layout, group):
    """(layout, P, group) of an ops.pair_score call."""
    return (layout, c_fields[0].shape[0], group)


def _topk_key(scores, k, signed_zeros=False):
    """(B, N, k) of a top-k call (ops.topk_select, or the sharded
    shortlist's in lax.top_k's order)."""
    return (*scores.shape, k)


def run_multimodal_path(torch, n_points: int, dev) -> tuple[dict, dict]:
    """The multi-modal phase: (a) the ``products-multimodal``
    configuration, the main path's traffic on an ogbn-products-like corpus
    cut to ``n_points`` with ``GusConfig(multimodal=...)`` (two-stage
    retrieval: the sparse_dot_batched distances and pair_score rescore);
    (b) the Android-Security time-to-flag through
    ``benchmarks/torch_time_to_flag.py`` on the card. The launch counts
    cover both. Returns the metrics and the shapes its kernels were
    given."""
    from repro_torch.ann.brute import BruteIndex
    from repro_torch.ann.scann import ScannConfig
    from repro_torch.core import gus as gus_module
    from repro_torch.core.buckets import BucketConfig
    from repro_torch.core.gus import DynamicGUS, GusConfig
    from repro_torch.core.scorer import train_scorer
    from repro_torch.data.stream import MutationStream, StreamConfig
    from repro_torch.data.synthetic import (OGB_PRODUCTS_LIKE, labeled_pairs,
                                            make_dataset)
    from repro_torch.kernels import ops
    from repro_torch.multimodal import MultiModalConfig
    sys.path.insert(0, str(SRC.parent))
    from benchmarks import torch_time_to_flag

    data = dataclasses.replace(OGB_PRODUCTS_LIKE, n_points=n_points)
    # launch/serve.py's buckets and serving config for this corpus
    buckets = BucketConfig(dense_tables=8, dense_bits=10, set_tables=6,
                           scalar_widths=(2.0,))
    cfg = GusConfig(scann_nn=10, scann=ScannConfig(
        d_proj=64, n_partitions=max(16, n_points // 256), nprobe=8,
        reorder=128), multimodal=MultiModalConfig(
            sparse_k=10, postings_cap=64, d_sketch=64, idf_size=512,
            filter_percent=1.0, reload_every=5))
    t0 = time.perf_counter()
    ids, feats, cluster = make_dataset(data)
    pf, lbl = labeled_pairs(feats, cluster, min(4 * n_points, 20_000),
                            data.spec, seed=0)
    stream = MutationStream(data, StreamConfig(seed=0), bootstrap_fraction=0.6)
    boot_ids, boot_feats = stream.bootstrap()
    print(f"[multimodal] data ready in {time.perf_counter() - t0:.1f} s: "
          f"{n_points} points, {len(boot_ids)} bootstrapped")

    # the shapes this phase gives the two-stage retrieval and the brute
    # search, recorded until the launch counts are read
    two_stage, brute = set(), set()
    recording = contextlib.ExitStack()
    recording.enter_context(_record_calls(
        gus_module, "two_stage_neighbors", _two_stage_key, two_stage))
    recording.enter_context(_record_calls(BruteIndex, "search", _brute_key,
                                          brute))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scorer, losses = train_scorer(0, data.spec, pf, lbl, steps=300,
                                  device=dev)
    gus = DynamicGUS(data.spec, buckets, scorer, cfg, device=dev)
    gus.bootstrap(boot_ids, boot_feats)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    print(f"[multimodal] scorer loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"bootstrap {boot_s:.1f} s; k_max {gus.embedder.k_max}; "
          + json.dumps(gus.multimodal.describe()))

    gus.mutate(next(stream))
    gus.neighbors_of_ids(stream.query_ids(16))
    first_ms = (gus.mutation_timer.samples_ms.pop(),
                gus.query_timer.samples_ms.pop())
    rescore = gus.multimodal.obs.registry.get("multimodal_rescore_ms")
    rescore.reset()                        # the set-up RPC's is not steady
    same = []
    for i, batch in zip(range(20), stream):
        gus.mutate(batch)
        if i % 2 == 1:
            qids = stream.query_ids(16)
            res = gus.neighbors_of_ids(qids)
            if res.ids.shape != (16, 10) or not np.isfinite(
                    res.weights[res.ids >= 0]).all():
                raise AssertionError("multi-modal RPC returned bad rows")
            same += [cluster[n] == cluster[q] for r, q in enumerate(qids)
                     for n in res.ids[r] if 0 <= n < len(cluster)]
    same_rate = float(np.mean(same))
    torch.cuda.synchronize()
    mut = gus.mutation_timer.summary()
    qry = gus.query_timer.summary()
    out = dict(config="products-multimodal", n_points=n_points,
               bootstrapped=len(boot_ids), bootstrap_s=boot_s,
               first_mutation_ms=first_ms[0], first_neighbors_ms=first_ms[1],
               mutation_p50_ms=mut["p50_ms"], mutation_p99_ms=mut["p99_ms"],
               neighbors_p50_ms=qry["p50_ms"], neighbors_p99_ms=qry["p99_ms"],
               rescore_p50_ms=rescore.summary()["p50_ms"],
               store=gus.multimodal.describe(), same_cluster=same_rate,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    # the union's width: dense k + 1 (the self id is dropped) + sparse_k
    r_max = cfg.scann_nn + 1 + cfg.multimodal.sparse_k
    out["profile"] = profile_rpcs(torch, gus, stream, label="multimodal ")
    out["host_top"] = {
        "neighbors": host_profile(torch, gus.neighbors_of_ids,
                                  [stream.query_ids(16) for _ in range(4)],
                                  "multimodal neighbors"),
        "mutation": host_profile(torch, gus.mutate,
                                 [next(stream) for _ in range(4)],
                                 "multimodal mutation")}
    print("[multimodal] " + json.dumps(
        {k: v for k, v in out.items() if k not in ("profile", "host_top")}))
    if not same_rate > 0.7:
        raise AssertionError(f"multi-modal same-cluster rate {same_rate} "
                             f"<= 0.7")
    # the products index's rescore of a 16-id RPC (K = k_max) and its
    # pair scoring (16 x r_max pairs), for phase 5
    shapes = dict(mm_rescore=(16, cfg.scann.nprobe * gus.index.slab,
                              cfg.scann.reorder, gus.index.capacity,
                              gus.embedder.k_max, cfg.scann_nn + 1),
                  mm_spec=data.spec, mm_pair=(16 * r_max, r_max),
                  mm=(16, r_max, gus.embedder.k_max))
    del gus

    t0 = time.perf_counter()
    flag = torch_time_to_flag.run(device=dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    recording.close()
    out["time_to_flag"] = dict(
        ratio=flag["ratio"], rescore_p50_ms=flag["rescore_p50_ms"],
        scorer_final_loss=flag["scorer_final_loss"],
        wall_s=time.perf_counter() - t0,
        **{f"{m}_flagged": f"{flag[m]['flagged']}/{flag[m]['total']}"
           for m in ("dense", "multimodal")},
        **{f"{m}_mean_mutations": flag[m]["mean_mutations"]
           for m in ("dense", "multimodal")})
    out["launches"] = counts
    print("[multimodal] time-to-flag " + json.dumps(out["time_to_flag"])
          + "; launches " + json.dumps(counts))
    _require_launched(counts, ("sparse_dot_batched", "pair_score",
                               "fused_query", "sparse_rescore_topk",
                               "sparse_dot", "topk_select"),
                      "the multi-modal path", forbidden=("scorer_mlp",))
    if not flag["ratio"] >= torch_time_to_flag.RATIO_GATE:
        raise AssertionError(f"time-to-flag ratio {flag['ratio']} < "
                             f"{torch_time_to_flag.RATIO_GATE}")
    return out, dict(shapes, mm_calls=sorted(two_stage, key=lambda c: c[1:]),
                     brute_calls=sorted(brute))


# ---------------------------------------------------------------- phase 8

BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
# (the bounds below count the bf16 products only: the f32 attention
# products and the elementwise passes come on top)
LM_SIZE = dict(batch=8, prompt=512, new=32, max_len=1024, long=3000,
               exact=(2, 128))
# the decode-vs-prefill bound of phase 8 (a): this many times the largest
# gap between the bf16 prefill's logits and the f32 model's on the same
# prompts (phase 8 (b)). Decode and prefill each sit within about that gap
# of the f32 answer, so their distance is within twice it; the other two
# allow for positions and requests where the decode's rounding is the
# larger one.
DECODE_GAP_FACTOR = 4.0
LM_PROFILE_REPS = 6              # decode steps a profiler window holds


def _lm_leaves(params) -> list:
    return [t for v in params.values()
            for t in (v.values() if isinstance(v, dict) else (v,))]


def _call_summary(calls, top: int = 6) -> dict:
    """Device ms per call, device records per call, and the ``top``
    kernels by device ms per call (names cut to 80 characters), from
    ``_profile_calls``."""
    by_name = collections.Counter()
    for call in calls:
        for name, us in call:
            by_name[name[:80]] += us / len(calls) / 1e3
    return dict(device_ms=sum(by_name.values()), records=len(calls[0]),
                calls=len(calls),
                top=[[name, ms] for name, ms in by_name.most_common(top)])


def _upcast(params, dtype) -> None:
    """Every leaf of ``params`` to ``dtype`` in place, one tensor at a
    time, so the old copy is freed as the new one is made."""
    for key, value in params.items():
        if isinstance(value, dict):
            _upcast(value, dtype)
        else:
            params[key] = value.to(dtype)


def _logit_gap(torch, got, want, vocab: int) -> dict:
    """``got`` against ``want`` over the first ``vocab`` logits: max abs,
    relative L2 and the share of positions whose argmax agrees."""
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    return dict(max_abs=float((got - want).abs().max()),
                rel_l2=float(torch.linalg.vector_norm(got - want)
                             / torch.linalg.vector_norm(want)),
                argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                                   .float().mean()))


def _wall_ms(torch, fn, reps: int) -> list:
    """Wall ms of ``reps`` calls, each ending in a device synchronise (the
    caller has made the warm-up call)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _serve_prompts(torch, step, params, cache, prompts, new: int,
                   prefill=None):
    """Serve ``prompts`` [B, P] as the reference's decode test does: one
    decode step per prompt token into ``cache``, then ``new`` greedy
    tokens. Returns the greedy tokens [B, new], each step's wall ms, and,
    with ``prefill`` ([B, P, V] logits of the same prompts), the max abs
    gap of each prompt step's logits to the prefill's [P, B]."""
    gaps, times, out = [], [], []
    finite = torch.ones((), dtype=torch.bool, device=prompts.device)
    tok = None
    for t in range(prompts.shape[1] + new):
        feed = prompts[:, t] if t < prompts.shape[1] else tok
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, logits, cache = step(params, cache, feed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        finite &= torch.isfinite(logits).all()
        if t >= prompts.shape[1]:
            out.append(tok)
        elif prefill is not None:
            gaps.append((logits - prefill[:, t, :logits.shape[-1]].float())
                        .abs().amax(-1))
    if not bool(finite):
        raise AssertionError("a decode step gave a non-finite logit")
    gap = torch.stack(gaps) if gaps else None
    return torch.stack(out, 1), times, gap


def _lm_estimate(cfg, n_params: int, size: dict) -> dict:
    """Phase 8's peak memory and time from its shapes: (a) holds the bf16
    weights, the cache and the kept prefill logits, and on top of them
    the largest of: the 3,000-token prompt's logits and four f32 score
    tiles of its flash chunk; its logits twice (flash and full attention)
    and their comparison (the up-cast pair and two f32 temporaries); the
    first logits and three f32 score tensors of full attention; (b) the f32
    weights, the kept bf16 logits, the f32 logits of the same prompts and
    three f32 temporaries of their comparison.
    Time: each decode step (both passes of (a), the f32 requests of (b))
    at the larger of its weight-read bound and its host launches (about
    3,200 a step at 17 us each on the H100 machine's host, PERF.md
    section 6), plus 30 s for the prefills, the profile and the f32
    up-cast."""
    v, b, p = cfg.padded_vocab, size["batch"], size["prompt"]
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim_ * 2
    cache = kv * b * size["max_len"]
    chunk = min(cfg.attn_chunk, size["long"])
    flash = 4 * 4 * cfg.n_heads * size["long"] * chunk
    full = 3 * 4 * cfg.n_heads * size["long"] ** 2
    long = 2 * v * size["long"]
    peak_a = 2 * n_params + cache + 2 * v * b * p + max(
        long + flash, 2 * long + 4 * 2 * long, long + full)
    peak_b = 4 * n_params + 2 * v * b * p + 4 * 4 * v * b * p
    step_s = max(2 * n_params / HBM_BYTES_PER_S, 3200 * 17e-6)
    steps = 2 * (p + size["new"]) + size["exact"][1]
    return dict(peak_a_gb=peak_a / 1e9, peak_b_gb=peak_b / 1e9,
                seconds=steps * step_s + 30.0)


def run_lm_path(torch, dev, cfg=None, **size) -> dict:
    """Phase 8: the LM tower's dense serving path at qwen3-8b's published
    widths and full depth (``cfg``; a rehearsal passes a cut one, and
    ``size`` cuts the requests), through ``make_prefill_step`` and
    ``make_decode_step``.

    (a) bf16 params and compute, from seed 0 on the card: one prefill of
    8 seeded prompts of 512 tokens (timed); the same 8 served by the
    decode step, one step per prompt token into ``init_cache(cfg, 8,
    1024)``, then 32 greedy tokens, twice, the greedy tokens bit for bit
    equal; each prompt step's logits against the prefill's; one decode
    step profiled (device busy per step, its launches, idle share); one
    prefill of a 3,000-token prompt (the flash path, padded), held against
    the same prompt through full attention. (b) the
    same weights up-cast to f32: the teacher-forced logits of the 8
    prompts (the bf16 prefill's gap to them: max abs, relative L2,
    argmax agreement, on the first 128 tokens of 2 requests and on all),
    then 2 requests of 128 tokens decoded, within 1e-3 of those logits
    at every position. The decode-vs-prefill gap of (a) must stay within
    ``DECODE_GAP_FACTOR`` times the bf16 prefill's largest gap to f32, and
    so must the 3,000-token prompt's flash-vs-full gap. No GUS kernel may
    launch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.serve import make_decode_step, make_prefill_step

    size = dict(LM_SIZE, **size)
    cfg = cfg or get_config("qwen3-8b")
    b, p, new = size["batch"], size["prompt"], size["new"]
    nb, nt = size["exact"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()

    # (a) the served model, bf16
    params = build_model(cfg).init_params(0, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = _lm_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    weights_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    del leaves
    # the params of the products (the embed is a gather, norms are scales)
    mm_params = params["lm_head"].numel() + sum(
        params["blocks"][name].numel()
        for name in ("wq", "wk", "wv", "wo", "gate", "up", "down"))
    cache_gb = (2 * cfg.n_layers * b * size["max_len"] * cfg.n_kv_heads
                * cfg.head_dim_ * cfg.cdtype.itemsize / 1e9)
    est = _lm_estimate(cfg, n_params, size)
    print(f"[lm] {cfg.arch_id}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim_}, "
          f"ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params:,} params, "
          f"{weights_gb:.2f} GB {cfg.param_dtype}, drawn in "
          f"{init_s:.2f} s; estimate: peak {est['peak_a_gb']:.1f} GB (a), "
          f"{est['peak_b_gb']:.1f} GB (b), {est['seconds']:.0f} s; "
          f"{held_gb:.2f} GB held by earlier phases")
    rng = np.random.default_rng(8)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, p)),
                              dtype=torch.int32, device=dev)
    long_prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, size["long"])),
        dtype=torch.int32, device=dev)
    prefill = make_prefill_step(cfg)
    logits = prefill(params, {"tokens": prompts})
    if (logits.shape != (b, p, cfg.padded_vocab)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are "
                             f"not all finite or not [B, P, Vp]")
    prefill_ms = _wall_ms(torch, lambda: prefill(params, {"tokens": prompts}),
                          3)
    split = {"init_prefill": time.perf_counter() - t0}
    t0 = time.perf_counter()

    step = make_decode_step(cfg)
    tokens, _, gap = _serve_prompts(
        torch, step, params, T.init_cache(cfg, b, size["max_len"], dev),
        prompts, new, prefill=logits)
    cache = T.init_cache(cfg, b, size["max_len"], dev)
    again, step_ms, _ = _serve_prompts(torch, step, params, cache, prompts,
                                       new)
    if not torch.equal(tokens, again):
        raise AssertionError("greedy tokens differ between two passes from "
                             "the same seed")
    split["decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    last = tokens[:, -1]
    decode_prof = _call_summary(_profile_calls(
        lambda: step(params, cache, last), torch, reps=LM_PROFILE_REPS))
    prefill_prof = _call_summary(_profile_calls(
        lambda: prefill(params, {"tokens": prompts}), torch, reps=2))
    split["profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    long_logits = prefill(params, {"tokens": long_prompt})
    if (long_logits.shape != (1, size["long"], cfg.padded_vocab)
            or not bool(torch.isfinite(long_logits).all())):
        raise AssertionError("the 3,000-token prefill gave a non-finite "
                             "logit")
    # the same prompt through full attention (``attn_chunk`` at its
    # length): flash's chunk offsets and padding held at every position
    full_logits = make_prefill_step(dataclasses.replace(
        cfg, attn_chunk=size["long"]))(params, {"tokens": long_prompt})
    flash_gap = _logit_gap(torch, long_logits, full_logits, cfg.vocab_size)
    del long_logits, full_logits
    long_ms = _wall_ms(torch, lambda: prefill(params,
                                              {"tokens": long_prompt}), 3)
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    del cache
    split["long"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (b) the same weights in f32
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    _upcast(params, torch.float32)
    want = make_prefill_step(cfg32)(params, {"tokens": prompts})
    exact_gap = _logit_gap(torch, logits[:nb, :nt], want[:nb, :nt],
                           cfg.vocab_size)
    all_gap = _logit_gap(torch, logits, want, cfg.vocab_size)
    del logits
    cache = T.init_cache(cfg32, nb, nt, dev)
    errs = []
    decode32 = make_decode_step(cfg32)
    for t in range(nt):
        _, dl, cache = decode32(params, cache, prompts[:nb, t])
        errs.append((dl - want[:nb, t, :cfg.vocab_size]).abs().max())
    decode_err = float(torch.stack(errs).max())
    peak_b = torch.cuda.max_memory_allocated() / 1e9
    split["f32"] = time.perf_counter() - t0
    del params, want, cache
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    torch.cuda.empty_cache()

    prompt_gap = float(gap.max())
    bound = DECODE_GAP_FACTOR * all_gap["max_abs"]
    p50 = float(np.percentile(step_ms, 50))
    out = dict(
        arch=cfg.arch_id, params=n_params, weights_gb=weights_gb,
        init_s=init_s, estimate=est, peak_a_gb=peak_a, peak_b_gb=peak_b,
        prefill_ms=float(np.median(prefill_ms)),
        prefill_tok_s=b * p / (float(np.median(prefill_ms)) / 1e3),
        long_prefill_ms=float(np.median(long_ms)),
        long_prefill_tok_s=size["long"] / (float(np.median(long_ms)) / 1e3),
        prefill_bound_ms=2 * mm_params * b * p / BF16_OPS_PER_S * 1e3,
        long_prefill_bound_ms=(2 * mm_params * size["long"] / BF16_OPS_PER_S
                               * 1e3),
        decode_bound_ms=(weights_gb + cache_gb) * 1e9 / HBM_BYTES_PER_S * 1e3,
        decode_p50_ms=p50, decode_p99_ms=float(np.percentile(step_ms, 99)),
        decode_tok_s=b / (p50 / 1e3), decode_steps=len(step_ms),
        decode_device_ms=decode_prof["device_ms"],
        decode_idle_share=1.0 - decode_prof["device_ms"] / p50,
        decode_profile=decode_prof, prefill_profile=prefill_prof,
        split_s=split,
        decode_vs_prefill=prompt_gap, decode_vs_prefill_bound=bound,
        long_flash_vs_full=flash_gap,
        bf16_vs_f32_2x128=exact_gap, bf16_vs_f32_all=all_gap,
        f32_decode_vs_tf=decode_err, launches=counts,
        phase_s=time.perf_counter() - t_phase)
    print("[lm] " + json.dumps(out))
    if any(counts.values()):
        raise AssertionError(f"the LM path launched GUS kernels: {counts}")
    if not decode_err < 1e-3:
        raise AssertionError(f"f32 decode vs teacher-forced: {decode_err} "
                             f">= 1e-3")
    if not prompt_gap <= bound:
        raise AssertionError(f"bf16 decode vs prefill: {prompt_gap} > "
                             f"{DECODE_GAP_FACTOR} x {all_gap['max_abs']}")
    if not flash_gap["max_abs"] <= bound:
        raise AssertionError(f"the 3,000-token prefill, flash vs full "
                             f"attention: {flash_gap['max_abs']} > "
                             f"{DECODE_GAP_FACTOR} x {all_gap['max_abs']}")
    return out


# ---------------------------------------------------------------- phase 9

# the models of phase 9 and the cut each runs at: jamba-1.5-large-398b
# keeps one interleave group (8 of 72 layers: attention, 4 mamba + MoE, 3
# mamba + dense) and 8 of its 16 experts (top-2 kept); every width is the
# published one. The others run whole.
FAMILY_CUTS = (("qwen2-moe-a2.7b", {}), ("xlstm-1.3b", {}),
               ("whisper-tiny", {}),
               ("jamba-1.5-large-398b", dict(n_layers=8, n_experts=8)))
FAMILY_SIZE = dict(batch=8, prompt=512, served=64, new=32, max_len=1024,
                   long=3000, exact=(2, 64))


def _no_drop(cfg):
    """``cfg`` at capacity_factor E / k for a moe model: capacity >= S,
    so no token can drop and each token's output is its own (decode and
    prefill then compute the same function)."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.moe_top_k)


@contextlib.contextmanager
def _count_drops(stats: dict):
    """Count the (token, expert) pairs that ``moe.dispatch`` sees and the
    ones its capacity cut drops, while the context is open (one host read
    a layer: only around an untimed call)."""
    from repro_torch.models import moe
    dispatch = moe.dispatch

    def counted(top_e, n_experts, cap):
        out = dispatch(top_e, n_experts, cap)
        stats["pairs"] = stats.get("pairs", 0) + out[2].numel()
        stats["dropped"] = stats.get("dropped", 0) + int((~out[2]).sum())
        return out

    moe.dispatch = counted
    try:
        yield stats
    finally:
        moe.dispatch = dispatch


@contextlib.contextmanager
def _slstm_host(into: list):
    """Host ms of each ``ssm.slstm_train`` call (its per-token launch loop,
    without a synchronise) while the context is open."""
    from repro_torch.models import ssm
    train = ssm.slstm_train

    def timed(p, cfg, x):
        t0 = time.perf_counter()
        out = train(p, cfg, x)
        into.append((time.perf_counter() - t0) * 1e3)
        return out

    ssm.slstm_train = timed
    try:
        yield into
    finally:
        ssm.slstm_train = train


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def family_plan(cfg, size: dict = FAMILY_SIZE) -> dict:
    """Phase 9's sizes and bounds for ``cfg``, from its params and cache
    trees on the ``meta`` device (no memory; runs on any machine):

    * params, bf16 GB, the cache's GB at 8 x ``max_len``;
    * decode bound: the bytes a step must move (every weight once: the
      MoE formulation computes every expert at capacity 1; the KV caches
      read once; the recurrent state read and written) over the card's
      memory rate;
    * prefill bound: the bf16 products of 8 x ``prompt`` tokens (dense
      weights 2 x numel a token; experts 2 x numel x capacity a sequence,
      at the published capacity factor) over the bf16 peak; the f32
      products (router, mLSTM gates, attention scores) and the scans come
      on top;
    * peak (a): the bf16 weights, the cache, the kept served logits (bf16
      and f32), the prefill's logits twice, and the largest transient of a
      layer: the MoE's expert buffers at capacity E / k (the no-drop
      prefill of the served prompts), three [B, E, cap, ff] bf16 tensors
      and one [B, E, cap, d]; the selective scan's four [B, 64, dI, dS] f32
      blocks; the parallel mLSTM's three [1, H, long, long] f32 matrices;
    * peak (b): the f32 weights, or for the hybrid (whose cut's f32 copy
      does not fit) the bf16 weights and its largest layer in f32, plus the
      f32 and bf16 logits of the served prompts twice."""
    from repro_torch.models import build_model
    from repro_torch.models.moe import capacity

    api = build_model(cfg)
    leaves = dict(_named_leaves(api.init_params(0, cfg, "meta")))
    cache = api.init_cache(cfg, size["batch"], size["max_len"], "meta")
    nbytes = lambda t: t.numel() * t.element_size()
    n_params = sum(t.numel() for t in leaves.values())
    cache_bytes = sum(nbytes(t) for _, t in _named_leaves(cache))
    state_bytes = cache_bytes - sum(nbytes(cache[k]) for k in
                                    ("k", "v", "xk", "xv") if k in cache)
    b, p, v = size["batch"], size["prompt"], cfg.padded_vocab
    dense = sum(t.numel() for name, t in leaves.items()
                if t.dtype == cfg.pdtype and t.ndim > 1 and "embed" not in
                name and "/moe/w_" not in name)
    expert = sum(t.numel() for name, t in leaves.items()
                 if "/moe/w_" in name)
    cap = capacity(cfg, p) if cfg.n_experts else 0
    prefill_flops = 2 * b * (p * dense + cap * expert)
    weights = sum(nbytes(t) for t in leaves.values())
    served = b * size["served"] * v * (2 + 4)
    trans = 0
    if cfg.n_experts:
        trans = 2 * b * cfg.n_experts * size["served"] * (
            3 * cfg.expert_ff() + cfg.d_model)
    if cfg.family == "hybrid":
        di = cfg.ssm_expand * cfg.d_model
        trans = max(trans, 4 * 4 * b * 64 * di * cfg.ssm_d_state)
    if cfg.family == "ssm":
        trans = max(trans, 3 * 4 * cfg.n_heads * size["long"] ** 2)
    peak_a = weights + cache_bytes + served + 2 * 2 * b * p * v + trans
    if cfg.family == "hybrid":
        layer = max(sum(t.numel() for name, t in leaves.items()
                        if name.startswith(kind)) // n
                    for kind, n in (("attn", cfg.n_layers // 8),
                                    ("mamba_moe", cfg.n_layers // 2),
                                    ("mamba_dense", cfg.n_layers * 3 // 8)))
        peak_b = weights + 4 * layer
    else:
        peak_b = 4 * n_params
    peak_b += 2 * b * size["served"] * v * (4 + 2)
    return dict(params=n_params, weights_gb=weights / 1e9,
                cache_gb=cache_bytes / 1e9, state_gb=state_bytes / 1e9,
                decode_bound_ms=(weights + cache_bytes + state_bytes)
                / HBM_BYTES_PER_S * 1e3,
                prefill_bound_ms=prefill_flops / BF16_OPS_PER_S * 1e3,
                capacity=cap, peak_a_gb=peak_a / 1e9, peak_b_gb=peak_b / 1e9)


def _hybrid_f32_logits(torch, params, cfg32, tokens):
    """The hybrid's teacher-forced logits in f32 from bf16 weights, one
    layer's weights up-cast at a time, in ``hybrid._group_train``'s order
    (the jamba cut's f32 copy, 103.7 GB, does not fit the card)."""
    from repro_torch.models import hybrid as H
    from repro_torch.models import layers as L
    from repro_torch.models import ssm

    up = functools.partial(L.map_tree, lambda t: t.float())
    x = params["embed"][tokens].float()
    for g in range(cfg32.n_layers // cfg32.attn_period):
        ap = up(L.index(params["attn"], g))
        x = x + H._attn_train(ap, cfg32, x)
        x = x + H._dense_ffn(ap, cfg32, x)
        del ap
        for kind, i in H._mamba_layers(cfg32):
            lp = up(L.index(params[kind], g, i))
            x = x + ssm.mamba_train(lp["mamba"], cfg32, x)
            x = x + (H._moe_ffn(lp, cfg32, x)[0] if kind == "mamba_moe"
                     else H._dense_ffn(lp, cfg32, x))
            del lp
    x = L.rms_norm(x, params["final_norm"], cfg32.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"].float())


def _exact_decode(torch, api, cfg32, params, batch, nb: int, nt: int):
    """f32 decode of ``nb`` requests x ``nt`` tokens against the f32
    teacher-forced logits of the same tokens: (the largest gap, the
    teacher-forced batch, its logits)."""
    from repro_torch.models import encdec
    from repro_torch.serve import make_decode_step, make_prefill_step

    sub = {k: v[:nb] for k, v in batch.items()}
    sub["tokens"] = sub["tokens"][:, :nt]
    want = make_prefill_step(cfg32)(params, sub)
    cache = api.init_cache(cfg32, nb, nt, want.device)
    if cfg32.family == "encdec":
        cache = encdec.encode_prefill(params, cfg32, sub["frames"], cache)
    step = make_decode_step(cfg32)
    errs = []
    for t in range(nt):
        _, dl, cache = step(params, cache, sub["tokens"][:, t])
        errs.append((dl - want[:, t, :cfg32.vocab_size]).abs().max())
    return float(torch.stack(errs).max()), sub, want


def _max_gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _serve_family(torch, dev, cfg, size: dict) -> dict:
    """Phase 9 for one model (``cfg``): (a) in bf16, from seed 0, a timed
    prefill of 8 x 512 tokens at the published capacity factor (the drops
    counted), whisper's ``encode_prefill`` of 8 x 1,500 frames timed, the
    8 prompts' first ``served`` tokens served by the decode step and then
    ``new`` greedy tokens, twice (tokens bit for bit), each prompt step's
    logits against a no-drop prefill (capacity E / k) of the same tokens,
    one decode step profiled; xlstm's 3,000-token prompt through the
    chunkwise mLSTM against the parallel form, with the sLSTM loop's host
    time. (b) f32: the same weights up-cast in place (jamba: a layer at a
    time, since the cut's f32 copy does not fit), the no-drop prefill's gap
    to f32 (its largest value times ``DECODE_GAP_FACTOR`` bounds the
    decode-vs-prefill gap of (a) and xlstm's chunkwise-vs-parallel gap),
    and f32 decode against teacher-forced within 1e-3 (jamba at
    ``reduced_config``, from seed 0 on the card)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model, encdec, ssm
    from repro_torch.models import layers as L
    from repro_torch.serve import make_decode_step, make_prefill_step

    b, p, n, new = size["batch"], size["prompt"], size["served"], size["new"]
    nb, nt = size["exact"]
    api = build_model(cfg)
    plan = family_plan(cfg, size)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_model = t0 = time.perf_counter()
    params = api.init_params(0, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"[lm-families] {cfg.arch_id}: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, experts {cfg.n_experts}; drawn in {init_s:.2f} s;"
          f" plan " + json.dumps(plan))
    rng = np.random.default_rng(9)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (b, p)),
                                       dtype=torch.int32, device=dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (b, cfg.n_frames, cfg.d_model), device=dev,
            generator=torch.Generator(dev).manual_seed(9))
    split = {}

    # (a) bf16: the prefill at the published capacity factor
    t0 = time.perf_counter()
    prefill = make_prefill_step(cfg)
    slstm_ms = []
    drops = {}
    with _count_drops(drops), _slstm_host(slstm_ms):
        logits = prefill(params, batch)
    if (logits.shape != (b, p, cfg.padded_vocab)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{cfg.arch_id}: prefill logits "
                             f"{tuple(logits.shape)} are not all finite or "
                             f"not [B, P, Vp]")
    del logits
    prefill_ms = _wall_ms(torch, lambda: prefill(params, batch), 3)
    out = dict(arch=cfg.arch_id, plan=plan, init_s=init_s,
               prefill_ms=float(np.median(prefill_ms)),
               prefill_tok_s=b * p / (float(np.median(prefill_ms)) / 1e3),
               moe_pairs=drops.get("pairs", 0),
               moe_dropped=drops.get("dropped", 0),
               slstm_host_ms_prefill=sum(slstm_ms))
    served = {k: v for k, v in batch.items()}
    served["tokens"] = batch["tokens"][:, :n]
    cfg_nd = _no_drop(cfg)
    ref = make_prefill_step(cfg_nd)(params, served)
    split["prefill"] = time.perf_counter() - t0

    # (a) the decode step, from a fresh cache each pass
    t0 = time.perf_counter()

    def fresh_cache():
        cache = api.init_cache(cfg, b, size["max_len"], dev)
        if cfg.family == "encdec":
            cache = encdec.encode_prefill(params, cfg, batch["frames"], cache)
        return cache

    if cfg.family == "encdec":
        fresh_cache()
        out["encode_prefill_ms"] = float(np.median(_wall_ms(
            torch, fresh_cache, 3)))
    step = make_decode_step(cfg_nd)
    tokens, _, gap = _serve_prompts(torch, step, params, fresh_cache(),
                                    served["tokens"], new, prefill=ref)
    cache = fresh_cache()
    again, step_ms, _ = _serve_prompts(torch, step, params, cache,
                                       served["tokens"], new)
    if not torch.equal(tokens, again):
        raise AssertionError(f"{cfg.arch_id}: greedy tokens differ between "
                             f"two passes from the same seed")
    split["decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    last = tokens[:, -1]
    prof = _call_summary(_profile_calls(lambda: step(params, cache, last),
                                        torch, reps=LM_PROFILE_REPS))
    del cache
    split["profile"] = time.perf_counter() - t0
    p50 = float(np.percentile(step_ms, 50))
    out.update(decode_p50_ms=p50,
               decode_p99_ms=float(np.percentile(step_ms, 99)),
               decode_tok_s=b / (p50 / 1e3), decode_steps=len(step_ms),
               decode_device_ms=prof["device_ms"],
               decode_idle_share=1.0 - prof["device_ms"] / p50,
               decode_profile=prof)

    if cfg.family == "ssm":
        t0 = time.perf_counter()
        long_tok = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, size["long"])),
            dtype=torch.int32, device=dev)}
        long_host = []
        with _slstm_host(long_host):
            long_logits = prefill(params, long_tok)
        if not bool(torch.isfinite(long_logits).all()):
            raise AssertionError("the 3,000-token prefill gave a non-finite "
                                 "logit")
        out["long_prefill_ms"] = float(np.median(_wall_ms(
            torch, lambda: prefill(params, long_tok), 1)))
        out["slstm_host_ms_long"] = sum(long_host)
        # the whole model, chunkwise against parallel: reported; the
        # sLSTM's recurrence carries any rounding difference on along the
        # prompt (PERF.md section 6)
        parallel = make_prefill_step(dataclasses.replace(cfg, mlstm_chunk=0))(
            params, long_tok)
        out["long_model_chunkwise_vs_parallel"] = _logit_gap(
            torch, long_logits, parallel, cfg.vocab_size)
        del long_logits, parallel
        # held: the first mLSTM block on the prompt's embeddings, both forms
        x_long = params["embed"][long_tok["tokens"]].to(cfg.cdtype)
        with torch.inference_mode():
            long_block = [ssm.mlstm_train(
                L.index(params["mlstm"], 0, 0), dataclasses.replace(
                    cfg, mlstm_chunk=chunk), x_long)
                for chunk in (cfg.mlstm_chunk, 0)]
        split["long"] = time.perf_counter() - t0
    out["peak_a_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # (b) f32
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg32 = dataclasses.replace(cfg_nd, param_dtype="float32",
                                compute_dtype="float32")
    f32_bound = 1e-3
    if cfg.family == "hybrid":
        with torch.inference_mode():
            want = _hybrid_f32_logits(torch, params, cfg32, served["tokens"])
        del params
        cfg_r = dataclasses.replace(_no_drop(reduced_config(cfg.arch_id)),
                                    param_dtype="float32",
                                    compute_dtype="float32")
        api_r = build_model(cfg_r)
        params = api_r.init_params(0, cfg_r, dev)
        small = {"tokens": served["tokens"] % cfg_r.vocab_size}
        out["f32_decode_vs_tf"] = _exact_decode(torch, api_r, cfg_r, params,
                                                small, nb, nt)[0]
        out["f32_decode_at"] = "reduced_config"
    else:
        _upcast(params, torch.float32)
        want = make_prefill_step(cfg32)(params, served)
        err, sub, tf = _exact_decode(torch, api, cfg32, params, served, nb,
                                     nt)
        out["f32_decode_vs_tf"] = err
        out["f32_decode_at"] = "full size"
        if cfg.family == "ssm":
            # the same f32 function summed in another order (the chunkwise
            # mLSTM, four chunks): the deep recurrent model's own f32
            # noise, which decode vs teacher-forced shows too
            other = make_prefill_step(dataclasses.replace(
                cfg32, mlstm_chunk=max(nt // 4, 1)))(params, sub)
            out["f32_order_gap"] = _max_gap(other, tf)
            f32_bound = max(f32_bound,
                            DECODE_GAP_FACTOR * out["f32_order_gap"])
            del other
            x32 = params["embed"][long_tok["tokens"]]
            with torch.inference_mode():
                block32 = [ssm.mlstm_train(
                    L.index(params["mlstm"], 0, 0), dataclasses.replace(
                        cfg32, mlstm_chunk=chunk), x32)
                    for chunk in (cfg.mlstm_chunk, 0)]
            out["long_block_f32_chunkwise_vs_parallel"] = _max_gap(*block32)
            out["long_block_bf16_vs_f32"] = _max_gap(long_block[1],
                                                     block32[1])
            out["long_block_bf16_chunkwise_vs_parallel"] = _max_gap(
                *long_block)
            del block32, long_block
        del tf
    out["f32_bound"] = f32_bound
    all_gap = _logit_gap(torch, ref, want, cfg.vocab_size)
    out["bf16_vs_f32"] = all_gap
    out["peak_b_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, want, ref
    split["f32"] = time.perf_counter() - t0
    bound = DECODE_GAP_FACTOR * all_gap["max_abs"]
    out.update(decode_vs_prefill=float(gap.max()),
               decode_vs_prefill_bound=bound, split_s=split,
               model_s=time.perf_counter() - t_model)
    print("[lm-families] " + json.dumps(out))
    if not out["f32_decode_vs_tf"] < f32_bound:
        raise AssertionError(f"{cfg.arch_id}: f32 decode vs teacher-forced "
                             f"{out['f32_decode_vs_tf']} >= {f32_bound}")
    if not out["decode_vs_prefill"] <= bound:
        raise AssertionError(f"{cfg.arch_id}: bf16 decode vs prefill "
                             f"{out['decode_vs_prefill']} > "
                             f"{DECODE_GAP_FACTOR} x {all_gap['max_abs']}")
    if cfg.family == "ssm":
        if not out["long_block_f32_chunkwise_vs_parallel"] < 1e-3:
            raise AssertionError(
                f"the 3,000-token prompt's first mLSTM block in f32, "
                f"chunkwise vs parallel: "
                f"{out['long_block_f32_chunkwise_vs_parallel']} >= 1e-3")
        block_bound = DECODE_GAP_FACTOR * out["long_block_bf16_vs_f32"]
        if not out["long_block_bf16_chunkwise_vs_parallel"] <= block_bound:
            raise AssertionError(
                f"the 3,000-token prompt's first mLSTM block in bf16, "
                f"chunkwise vs parallel: "
                f"{out['long_block_bf16_chunkwise_vs_parallel']} > "
                f"{DECODE_GAP_FACTOR} x its bf16 gap to f32")
    return out


def run_lm_families_path(torch, dev, cuts=FAMILY_CUTS, **size) -> dict:
    """Phase 9: the LM tower's moe, ssm (xLSTM), encdec and hybrid families
    through ``make_prefill_step`` / ``make_decode_step`` (and
    ``encdec.encode_prefill``), each model as ``_serve_family`` says, at
    the published configs of ``cuts`` with the overrides given there (a
    rehearsal passes cut ones, and ``size`` cuts the requests). No GUS
    kernel may launch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    size = dict(FAMILY_SIZE, **size)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    models = [_serve_family(torch, dev, dataclasses.replace(
        get_config(arch), **cut), size) for arch, cut in cuts]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    torch.cuda.empty_cache()
    out = dict(models=models, launches=counts,
               phase_s=time.perf_counter() - t0)
    print(f"[lm-families] phase 9 in {out['phase_s']:.1f} s; GUS kernel "
          f"launches {counts}")
    if any(counts.values()):
        raise AssertionError(f"the LM families launched GUS kernels: "
                             f"{counts}")
    return out


# --------------------------------------------------------------- phase 10

# phase 10 (a): qwen3-8b trained at full width and depth. The one cut is
# bf16 moments: f32 moments (8 bytes a param, 65.5 GB) next to the bf16
# params and grads (32.8 GB) do not fit 80 GB.
TRAIN_SIZE = dict(batch=8, seq=512, steps=6, lr=1e-4, moments="bfloat16",
                  profile_reps=2, family_batch=4, family_seq=64,
                  family_steps=3, cli_steps=4)
TRAIN_FAMILIES = ("qwen2-moe-a2.7b", "qwen2-vl-7b", "xlstm-1.3b",
                  "whisper-tiny", "jamba-1.5-large-398b")
NORM_GAP = 0.01          # the microbatch 1 vs 2 pre-clip grad norm, relative


def train_plan(cfg, size: dict = TRAIN_SIZE) -> dict:
    """Phase 10 (a)'s memory and time bounds for ``cfg``, from its params
    on the ``meta`` device (runs on any machine). Peak: the params and the
    gradient tree in the param dtype, the two moments in the moment dtype,
    and on top of them, during a microbatch's backward: the layer inputs
    the checkpoints keep (one [T, d] a layer), one layer's recompute and
    backward (three f32 [B, H, S, S] attention tensors, six [T, ff] FFN
    tensors in the compute dtype, ten f32 [T, d] ones), the CE chunk's
    logits (compute dtype, f32, the softmax's f32 gradient and the f32
    input logsumexp keeps: 14 bytes a logit) and the optimizer's slice
    temporaries (six f32 slices of 2^26). Bound: the products, 8 x params
    x tokens (forward 2, backward 4, the checkpoints' recompute 2) over
    the bf16 peak, and the optimizer's traffic (params, m, v read and
    written, grads read) over the memory rate."""
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import moment_dtype
    from repro_torch.utils.tree import SLICE, leaves

    params = build_model(cfg).init_params(0, cfg, "meta")
    n = sum(t.numel() for t in leaves(params))
    pb = sum(t.numel() * t.element_size() for t in leaves(params))
    mb = 2 * n * moment_dtype(size["moments"]).itemsize
    micro = size["batch"] // max(cfg.microbatches, 1)
    t, s, cb = micro * size["seq"], size["seq"], cfg.cdtype.itemsize
    kept = cfg.n_layers * t * cfg.d_model * cb
    layer = (3 * 4 * micro * cfg.n_heads * s * s + 6 * t * cfg.d_ff * cb
             + 10 * 4 * t * cfg.d_model)
    ce = t * cfg.padded_vocab * (cb + 3 * 4)
    opt = 6 * 4 * SLICE
    tokens = size["batch"] * size["seq"]
    products_s = 8 * n * tokens / BF16_OPS_PER_S
    opt_bytes = 2 * pb + pb + 2 * mb      # params r/w, grads r, m and v r/w
    return dict(params=n, params_gb=pb / 1e9, grads_gb=pb / 1e9,
                moments_gb=mb / 1e9, kept_gb=kept / 1e9, layer_gb=layer / 1e9,
                ce_gb=ce / 1e9, opt_gb=opt / 1e9,
                peak_gb=(2 * pb + mb + kept + layer + ce + opt) / 1e9,
                products_s=products_s, opt_bytes_gb=opt_bytes / 1e9,
                opt_s=opt_bytes / HBM_BYTES_PER_S,
                bound_s=products_s + opt_bytes / HBM_BYTES_PER_S)


def _sliced_update_check(torch, leaf) -> dict:
    """``adamw_update`` on a copy of ``leaf`` (bf16 params, grads and
    moments from a seeded generator) against ``update_leaf`` on the whole
    leaf: the params and moments bit for bit, and how many slices the
    update took."""
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             step_scalars, update_leaf)
    from repro_torch.utils.tree import flat_slices

    gen = torch.Generator(leaf.device).manual_seed(10)
    draw = lambda s: (torch.randn(leaf.shape, generator=gen,
                                  device=leaf.device) * s).to(leaf.dtype)
    cfg = AdamWConfig(lr=1e-4, weight_decay=0.01, clip_norm=None,
                      moment_dtype=leaf.dtype)
    p, g = leaf.clone(), draw(1e-3)
    m, v = draw(1e-3), draw(1e-3).abs()
    state = {"step": torch.tensor(3, dtype=torch.int32, device=leaf.device),
             "m": {"w": m.clone()}, "v": {"w": v.clone()}}
    k = step_scalars(state["step"] + 1, cfg)
    whole = [p.clone(), m, v]
    update_leaf(whole[0], g, whole[1], whole[2], k, cfg.weight_decay,
                cfg.eps)
    params, state, _ = adamw_update({"w": g}, state, {"w": p}, cfg)
    got = [params["w"], state["m"]["w"], state["v"]["w"]]
    same = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(got, whole))
    return dict(shape=list(leaf.shape), slices=len(flat_slices(p)),
                bitwise=same)


def _train_batch(torch, cfg, batch: int, seq: int, dev, seed: int = 0):
    """One batch of ``MarkovTokens`` at ``cfg``'s vocab (the vlm family's
    stub extras, encdec's seeded frames), as tensors on ``dev``."""
    from repro_torch.data.tokens import MarkovTokens, TokenDataConfig
    from repro_torch.launch.train import vlm_extras

    host = next(MarkovTokens(TokenDataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch,
        seed=seed)).batches(1))
    out = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    if cfg.family == "vlm":
        out.update(vlm_extras(cfg, out, dev))
    if cfg.family == "encdec":
        rng = np.random.default_rng(seed)
        out["frames"] = torch.as_tensor(rng.normal(
            size=(batch, cfg.n_frames, cfg.d_model)), dtype=torch.float32,
            device=dev)
    return out


def _falls(losses: list) -> bool:
    return all(np.isfinite(losses)) and losses[-1] < losses[0]


def _train_full(torch, dev, cfg, size: dict) -> dict:
    """Phase 10 (a), as ``run_train_path`` says."""
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import (accumulate_grads,
                                              make_loss_fn, make_train_step)
    from repro_torch.utils.tree import global_norm

    plan = train_plan(cfg, size)
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9 \
        if dev.type == "cuda" else float("nan")
    print(f"[train] {cfg.arch_id}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {plan['params']:,} params, "
          f"microbatches {cfg.microbatches}, {size['moments']} moments; "
          f"estimate (meta device): params {plan['params_gb']:.2f} + grads "
          f"{plan['grads_gb']:.2f} + moments {plan['moments_gb']:.2f} + "
          f"kept inputs {plan['kept_gb']:.2f} + a layer "
          f"{plan['layer_gb']:.2f} + CE chunk {plan['ce_gb']:.2f} + "
          f"optimizer slices {plan['opt_gb']:.2f} = peak "
          f"{plan['peak_gb']:.2f} GB of the card's {total_gb:.2f} GB")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(cfg).init_params(0, cfg, dev)
    batch = _train_batch(torch, cfg, size["batch"], size["seq"], dev)
    # the pre-clip grad norm in one microbatch, before the moments exist
    one = dataclasses.replace(cfg, microbatches=1)
    grads, _ = accumulate_grads(make_loss_fn(one), params, [batch])
    norm_1 = float(global_norm(grads))
    del grads
    opt_cfg = AdamWConfig(lr=size["lr"], weight_decay=0.01, clip_norm=1.0,
                          moment_dtype=size["moments"])
    state = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, norms, wall_ms = [], [], []
    for _ in range(size["steps"]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))      # a host read: the step is done
        wall_ms.append((time.perf_counter() - t1) * 1e3)
        norms.append(float(m["grad_norm"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    holder = [state]

    def one_step():
        _, holder[0], _ = step(params, holder[0], batch)

    prof = _call_summary(_profile_calls(one_step, torch,
                                        reps=size["profile_reps"]))
    sliced = _sliced_update_check(torch, params["blocks"]["gate"][:3])
    del params, state, holder, batch
    torch.cuda.empty_cache()
    p50 = float(np.percentile(wall_ms[1:], 50))
    tokens = size["batch"] * size["seq"]
    out = dict(arch=cfg.arch_id, params=plan["params"], plan=plan,
               card_gb=total_gb, peak_gb=peak_gb, setup_s=setup_s,
               losses=losses, grad_norms=norms, grad_norm_micro1=norm_1,
               grad_norm_gap=abs(norms[0] - norm_1) / norm_1,
               ln_vocab=float(np.log(cfg.vocab_size)), step_ms=wall_ms,
               step_p50_ms=p50, tokens_per_s=tokens / (p50 / 1e3),
               model_flop_share=8 * plan["params"] * tokens
               / (p50 / 1e3) / BF16_OPS_PER_S,
               bound_ms=plan["bound_s"] * 1e3,
               products_bound_ms=plan["products_s"] * 1e3,
               optimizer_bound_ms=plan["opt_s"] * 1e3,
               device_ms=prof["device_ms"], records=prof["records"],
               profiled_calls=prof["calls"], top=prof["top"],
               idle_share=1.0 - prof["device_ms"] / p50, sliced=sliced)
    print("[train] " + json.dumps(out))
    if not _falls(losses):
        raise AssertionError(f"qwen3-8b's loss is not finite or did not "
                             f"fall over {size['steps']} steps: {losses}")
    if not out["grad_norm_gap"] <= NORM_GAP:
        raise AssertionError(f"grad norm in 2 microbatches {norms[0]} vs 1 "
                             f"{norm_1}: {out['grad_norm_gap']} > {NORM_GAP}")
    if not sliced["bitwise"] or sliced["slices"] < 2:
        raise AssertionError(f"the sliced AdamW update: {sliced}")
    return out


def _train_families(torch, dev, size: dict) -> dict:
    """Phase 10 (b): each of ``TRAIN_FAMILIES`` at ``reduced_config`` in
    f32, ``family_steps`` steps on one batch; the loss must fall."""
    from repro_torch.configs import reduced_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    out = {}
    for arch in TRAIN_FAMILIES:
        cfg = reduced_config(arch)
        opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.01)
        params, state = init_train_state(0, cfg, opt_cfg, dev)
        batch = _train_batch(torch, cfg, size["family_batch"],
                             size["family_seq"], dev)
        step = make_train_step(cfg, opt_cfg)
        losses = []
        t0 = time.perf_counter()
        for _ in range(size["family_steps"]):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        out[arch] = dict(losses=losses, moe_aux=float(m["moe_aux"]),
                         seconds=time.perf_counter() - t0)
        if not _falls(losses):
            raise AssertionError(f"{arch}: the loss did not fall: {losses}")
    print("[train] families " + json.dumps(out))
    return out


def _train_cli(torch, dev, size: dict) -> dict:
    """Phase 10 (c): ``launch/train.py --reduced`` for qwen3-8b on the
    card, ``cli_steps`` straight against half of them, ``--resume``, then
    the rest: the later steps' metrics and the last checkpoint bit for
    bit. The checkpoints go under ``results/train/`` (gitignored) and are
    removed."""
    import shutil

    from repro_torch.launch import train as cli

    root = Path(__file__).resolve().parent / "results" / "train"
    shutil.rmtree(root, ignore_errors=True)
    n, half = size["cli_steps"], size["cli_steps"] // 2
    args = ["--arch", "qwen3-8b", "--reduced", "--batch", "8", "--seq",
            "128", "--ckpt-every", str(half), "--device", str(dev)]
    t0 = time.perf_counter()
    run = lambda *extra: cli.run(cli.parse_args([*args, *extra]))
    straight = run("--steps", str(n), "--ckpt", str(root / "a"))
    first = run("--steps", str(half), "--ckpt", str(root / "b"))
    resumed = run("--steps", str(n), "--ckpt", str(root / "b"), "--resume")
    last = f"step_{n:08d}/shard_0.npz"
    with np.load(root / "a" / last) as a, np.load(root / "b" / last) as b:
        same_ckpt = a.files == b.files and all(
            a[k].tobytes() == b[k].tobytes() for k in a.files)
    shutil.rmtree(root, ignore_errors=True)
    out = dict(losses=[m["loss"] for m in straight],
               resumed_equal=resumed == straight[half:]
               and first == straight[:half],
               checkpoint_equal=same_ckpt,
               seconds=time.perf_counter() - t0)
    print("[train] cli " + json.dumps(out))
    if not (out["resumed_equal"] and same_ckpt):
        raise AssertionError(f"--resume is not bitwise: {out}")
    return out


def _train_dp(torch, dev, size: dict) -> dict:
    """Phase 10 (d): the compressed data-parallel step (int8 codes, error
    feedback) at 2 shards of one mesh on the card, reduced qwen3-8b, 3
    steps on one batch; the loss must fall."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_gus_mesh
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_ef_state,
                                              init_train_state,
                                              make_compressed_dp_train_step)

    cfg = reduced_config("qwen3-8b")
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.01)
    params, state = init_train_state(0, cfg, opt_cfg, dev)
    state = init_ef_state(params, state)
    mesh = make_gus_mesh(2, device=dev)
    step = make_compressed_dp_train_step(cfg, opt_cfg, mesh)
    batch = _train_batch(torch, cfg, size["family_batch"],
                         size["family_seq"], dev)
    losses = []
    for _ in range(size["family_steps"]):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    out = dict(shards=mesh.size, devices=[str(d) for d in mesh.devices],
               losses=losses,
               ef_shape=list(state["ef"]["embed"].shape))
    print("[train] compressed dp " + json.dumps(out))
    if not _falls(losses) or out["ef_shape"][0] != 2:
        raise AssertionError(f"compressed DP at 2 shards: {out}")
    return out


def run_train_path(torch, dev, cfg=None, **size) -> dict:
    """Phase 10: training (``train/``, ``utils/tree.py``,
    ``data/tokens.py``, ``launch/train.py``).

    (a) qwen3-8b (``cfg``; a rehearsal passes a cut one, and ``size`` cuts
    the batch) at full width and depth in bf16 with bf16 moments, its
    published 2 microbatches, ``AdamWConfig(lr=1e-4, weight_decay=0.01,
    clip_norm=1.0)``, random init from seed 0, one batch of 8 x 512
    ``MarkovTokens`` (seed 0): the memory estimate from the ``meta``
    device beside the card's memory; the pre-clip grad norm in one
    microbatch (before the moments exist); 6 steps on that batch (wall
    with a synchronise); the loss finite and lower at step 6 than at step
    1, step 1's grad norm within 1% of the one-microbatch norm; one step
    profiled (device busy, idle share); the sliced AdamW update on three
    layers of the gate leaf ([3, 4,096, 12,288], three slices) bit for
    bit the whole-leaf formula; peak GB. (b) the other families at
    ``reduced_config``; (c) the CLI's ``--resume``; (d) the compressed
    data-parallel step at 2 shards. No GUS kernel may launch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    size = dict(TRAIN_SIZE, **size)
    cfg = cfg or get_config("qwen3-8b")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    out = dict(full=_train_full(torch, dev, cfg, size),
               families=_train_families(torch, dev, size),
               cli=_train_cli(torch, dev, size),
               dp=_train_dp(torch, dev, size))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    torch.cuda.empty_cache()
    out.update(launches=counts, phase_s=time.perf_counter() - t0)
    print(f"[train] phase 10 in {out['phase_s']:.1f} s; GUS kernel "
          f"launches {counts}")
    if any(counts.values()):
        raise AssertionError(f"the training path launched GUS kernels: "
                             f"{counts}")
    return out


# --------------------------------------------------------------- phase 11

# the architecture cells one H100 must hold whole (their plans: 4.8 and
# 33.9 GB); the plan may admit more
ARCH_CARD_CELLS = (("xlstm-1.3b", "long_500k"), ("whisper-tiny", "decode_32k"))


def _arch_line(rec: dict) -> list:
    """One record of phase 11's JSON line: ran, flops, bytes accessed,
    argument bytes a device, the plan's GB, and step ms and peak GB where
    the card ran it."""
    main = rec["main"]
    out = [rec["ran"], main["flops"], main["bytes_accessed"],
           main["memory"]["argument_bytes"], round(rec["plan"]["need_gb"], 3)]
    if rec["ran"] == "card":
        out += [rec["step_ms"], main["memory"]["peak_bytes"] / 1e9]
    return out


def run_dryrun_arch_path(torch, dev, archs=None, shapes=None,
                         card_cells=ARCH_CARD_CELLS, runs: int = 3,
                         out_dir: str = "results/dryrun") -> dict:
    """Phase 11: ``launch/dryrun.py::sweep`` over ``archs`` x ``shapes``
    (default: all) x both meshes on ``dev``, ``check=True``: every live
    cell sized on the meta device, the cells whose plan fits run whole on
    the card and checked. Fails on an ``error`` record, on a cell of
    ``card_cells`` that did not run on the card, or if a GUS kernel
    launched."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    recs = dryrun.sweep(list(archs or ARCHS), list(shapes or SHAPES),
                        [False, True], out_dir=out_dir, device=dev,
                        runs=runs, check=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    torch.cuda.empty_cache()
    out = dict(phase_s=time.perf_counter() - t0, launches=counts,
               records=len(recs),
               skipped=sum("skipped" in r for r in recs),
               errors=[r for r in recs if "error" in r])
    card = [r for r in recs if r.get("ran") == "card"]
    out["card"] = {f"{r['arch']}_{r['shape']}_{r['mesh']}": dict(
        step_ms=r["step_ms"], peak_gb=r["main"]["memory"]["peak_bytes"] / 1e9,
        temp_gb=r["main"]["memory"]["temp_bytes"] / 1e9,
        plan_gb=r["plan"]["need_gb"], build_s=r["build_s"],
        first_call_s=r["first_call_s"], check=r["check"],
        flops=r["main"]["flops"], bytes_accessed=r["main"]["bytes_accessed"])
        for r in card}
    for name, line in out["card"].items():
        print(f"[dryrun-arch] {name} on the card: " + json.dumps(line))
    print("[dryrun-arch] records " + json.dumps(
        {f"{r['arch']}_{r['shape']}_{r['mesh']}": _arch_line(r)
         for r in recs if "main" in r}))
    print(f"[dryrun-arch] phase 11 in {out['phase_s']:.1f} s: "
          f"{out['records']} records, {out['skipped']} skipped, "
          f"{len(card)} run on the card; GUS kernel launches {counts}")
    if out["errors"]:
        raise AssertionError(f"architecture cells failed: {out['errors']}")
    ran = {(r["arch"], r["shape"]) for r in card}
    missing = [c for c in card_cells if c not in ran]
    if missing or (card_cells and not card):
        raise AssertionError(f"cells that did not run on the card: "
                             f"{missing}")
    if any(counts.values()):
        raise AssertionError(f"the architecture cells launched GUS kernels: "
                             f"{counts}")
    return out


SOURCES = {  # kernel -> (CUDA source, TPU kernel it replaces, path)
    "fused_query": ("src/repro_torch/kernels/csrc/fused_query.cu",
                    "src/repro/kernels/fused_query.py:172", "main"),
    "fused_query_int8": ("src/repro_torch/kernels/csrc/fused_query.cu",
                         "src/repro/kernels/fused_query.py:203", "configs"),
    "sparse_rescore_topk": ("src/repro_torch/kernels/csrc/sparse_dot.cu",
                            "src/repro/kernels/sparse_dot.py:39", "main"),
    "sparse_dot_batched": ("src/repro_torch/kernels/csrc/sparse_dot.cu",
                           "src/repro/kernels/sparse_dot.py:39",
                           "multimodal"),
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
    t_start = t0 = time.perf_counter()
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
    graph_engine = ctx.pop("graph")
    del ctx
    serving = run_serving_path(torch, OGB_ARXIV_NODES, dev, graph_engine)
    del graph_engine
    sharded = run_sharded_path(torch, OGB_ARXIV_NODES, dev)
    multimodal, mm_shapes = run_multimodal_path(torch, OGB_ARXIV_NODES, dev)
    shapes.update(mm_shapes)
    shapes["serve_calls"] = serving.pop("calls")
    shapes["sharded_calls"] = sharded.pop("calls")
    shapes["brute_calls"] = sorted(set(shapes["brute_calls"])
                                   | shapes["serve_calls"].pop("brute")
                                   | shapes["sharded_calls"].pop("brute"))
    shapes.update(topk_merge=graph_shapes["merge"],
                  topk_read=graph_shapes["read"],
                  rescore_graph=graph_shapes["rescore"],
                  pair_graph=graph_shapes["pair"])
    report = check_kernels(torch, dev, shapes)
    # phase 7 after phase 5's other checks: its cells keep the card busy
    # for minutes, and phase 5's profiles are best read early (PERF.md
    # section 7); its own shapes are checked just after it
    dryrun = run_dryrun_path(torch, dev)
    report.update(check_dryrun_shapes(torch, dev, dryrun.pop("calls")))
    lm = run_lm_path(torch, dev)
    families = run_lm_families_path(torch, dev)
    train = run_train_path(torch, dev)
    arch = run_dryrun_arch_path(torch, dev)

    path_counts = {"main": main_path["launches"],
                   "configs": configs["launches"],
                   "graph": graph["launches"],
                   "multimodal": multimodal["launches"],
                   "serve": serving["launches"],
                   "sharded": sharded["launches"],
                   "dryrun": dryrun["launches"]}
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
            launches_multimodal=path_counts["multimodal"][name],
            launches_serve=path_counts["serve"][name],
            launches_sharded=path_counts["sharded"][name],
            launches_dryrun=path_counts["dryrun"][name],
            launches_lm=lm["launches"][name] + families["launches"][name],
            launches_train=train["launches"][name],
            launches_arch=arch["launches"][name],
            max_abs_err=rep["max_abs_err"], ms=rep["ms"],
            device_ms=rep["device_ms"], device_calls=rep.get("device_calls"),
            plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
            library_ms=rep.get("library_ms"), shape=rep["shape"]))
    for extra in ("topk_select read", "fused_query B=256",
                  "sparse_rescore_topk graph", "pair_score graph",
                  "sparse_dot_batched rescore shape",
                  "sparse_rescore_topk multimodal", "pair_score multimodal",
                  "fused_query sharded", "sparse_rescore_topk sharded",
                  "pair_score sharded", *sorted(
                      name for name in report if "dryrun" in name)):
        print(f"[kernels] {extra}: " + json.dumps(report[extra]))
    print(f"[smoke] every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
