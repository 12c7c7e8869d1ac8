"""Times of kernels, index and scoring steps and the neighborhood RPC of
two trees of the PyTorch/CUDA port, measured in turns on one card
(A B B A), for comparing a change with its parent in one run:

    python benchmarks/torch_kernel_ab.py --a PARENT_TREE --b . \\
        [--out kernel_ab.json]

Each turn is a subprocess (``--time TREE``) that imports ``TREE/src``'s
``repro_torch``, builds its kernels there, and times each shape with CUDA
events (mean of 20 calls after 3 warm-ups, as ``chip_smoke.py``) on inputs
made here from fixed seeds, so both trees see the same data. A kernel's
row also has its device time per call (``torch.profiler``, the sum of the
call's kernels) and its host time per call (the wrapper's enqueue, no
synchronise): where the host time is the larger, the events time the
wrapper, not the kernel. The shapes: the top-k at the graph's merge and
read shapes, the unfused shortlist's top-128 and a GraphConfig(k=10)
merge (k > 64), each beside the plain version and ``torch.topk``, and the
fused shortlist (f32 at B=16 and B=256, int8 at B=16; N = 8 slabs of
4,096, k = 128). Each turn also checks every kernel result against the
tree's plain version.

The scorers: ``sparse_dot`` (shared db) at B=64, N=131,072, K=9, and
``pq_score_batched`` (B=16, N=32,768) and ``pq_score`` (B=16,
N=131,072, shared codes) at M=8, C=256, each with events, device and host
ms and device kernels and copies per call, held bitwise against the
tree's plain version; ``ann.brute.BruteIndex.search`` for 64 queries,
k = 10, on a 131,072-slot index of 100,000 rows (5,000 deleted), whose
answer must be the first turn's (the last turn's, for the first) with
the distances bit for bit.

Steps, the functions both trees have, on state made here from seeds:
``ann.scann._query_step`` at B=16 and B=256 on one index state of the
arxiv layout (661 partitions of slabs of 4,096, probe 8, reorder 128,
k = 11, a slab of 262,144 rows of K = 9), each checked against the same
step on the CPU (the plain versions); ``_query_step`` with
``fused=False`` at B=16 (the pq-score kernel, the top-k and the dedup
mask), checked likewise; ``core.scorer.score_pairs`` on
arxiv feature rows at P=160 and P=4,096, aligned (both trees), and as the
neighborhood RPC scores (``rpc``: the parent repeats each query row on
the host, a tree whose ``score_pairs`` takes ``group`` passes the query
rows once). A step's row adds its device kernels and copies per call
(``torch.profiler``). Last, the neighborhood RPC on an engine of the
arxiv node count with the chip_smoke.py main-path configuration: wall,
device time, device kernels and copies per RPC over 8 RPCs of 16 ids.
Its check is between turns: the answer to one fixed RPC of 16 ids must
be the first turn's (the last turn's, for the first), the ids exactly and
the weights within pair_score's rtol 1e-5 / atol 1e-6 (trees may score
with another tanh). Every row carries ``equal``, and any false one fails
the run.

The last line is the JSON of all turns with the card's name and power
limit. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

WARMUP, REPS = 3, 20
TOPK = {"merge": (1024, 128, 64), "read": (16, 64, 8),
        "shortlist": (64, 32768, 128), "merge k=10": (1024, 144, 80)}
FUSED = {"f32 B=16": (16, False), "f32 B=256": (256, False),
         "int8 B=16": (16, True)}
N_FUSED, K_FUSED = 8 * 4096, 128
QUERY_STEP = (16, 256)          # queries per _query_step call
SPARSE = dict(b=64, n=131_072, k_dims=9, vocab=2000)
PQ = {"pq_score_batched": (16, 32768), "pq_score": (16, 131_072)}
BRUTE = dict(rows=100_000, deleted=5000, queries=64, k=10)
INDEX = dict(partitions=661, slab=4096, m=8, centers=256, d_proj=64,
             cap=262_144, k_dims=9, nprobe=8, reorder=128, k=11)
PAIRS = {"P=160": (16, 10), "P=4096": (256, 16)}   # query rows, group


def _topk_scores(b: int, n: int) -> np.ndarray:
    """Edge weights in (0, 1) with 30% -inf holes (cases.topk_inputs)."""
    rng = np.random.default_rng(n + b)
    s = rng.random((b, n)).astype(np.float32)
    s[rng.random((b, n)) < 0.3] = -np.inf
    return s


def _fused_inputs(b: int) -> list:
    rng = np.random.default_rng(b)
    n = N_FUSED
    return [rng.normal(size=(b, 8, 256)).astype(np.float32),
            rng.integers(0, 256, (b, n, 8), dtype=np.uint8),
            rng.integers(0, n // 2, (b, n)).astype(np.int32),
            rng.random((b, n)) >= 0.1,
            rng.normal(size=(b, n)).astype(np.float32)]


def _index_state() -> dict:
    """One seeded index state of the arxiv layout (``INDEX``): centroids,
    codebooks, slab members (30% empty), PQ codes, valid flags (5%
    tombstoned) and the sparse slab rows (vocabulary 2,000, so rows
    share indices with the queries; unit values, so any summation order
    gives the same bits and the card's step equals the CPU's in both
    trees)."""
    rng = np.random.default_rng(14)
    c, s, m = INDEX["partitions"], INDEX["slab"], INDEX["m"]
    cap, kd = INDEX["cap"], INDEX["k_dims"]
    members = rng.integers(0, cap, (c, s)).astype(np.int32)
    members[rng.random((c, s)) < 0.3] = -1
    sp_idx = np.sort(rng.integers(0, 2000, (cap, kd)), axis=1)
    sp_val = np.ones((cap, kd), np.float32)
    return dict(
        centroids=rng.normal(size=(c, INDEX["d_proj"])).astype(np.float32),
        books=rng.normal(size=(m, INDEX["centers"], INDEX["d_proj"] // m)
                         ).astype(np.float32),
        members=members,
        codes_list=rng.integers(0, INDEX["centers"], (c, s, m),
                                dtype=np.uint8),
        valid_list=(members >= 0) & (rng.random((c, s)) >= 0.05),
        sp_idx=sp_idx.astype(np.int64), sp_val=sp_val)


def _queries(b: int) -> dict:
    rng = np.random.default_rng(b)
    idx = np.sort(rng.integers(0, 2000, (b, INDEX["k_dims"])), axis=1)
    return dict(q_idx=idx.astype(np.int64),
                q_val=np.ones(idx.shape, np.float32),
                q_sketch=rng.normal(size=(b, INDEX["d_proj"])).astype(
                    np.float32))


def _sparse_rows(rows: int, seed: int) -> tuple:
    """Sorted indices below ``SPARSE['vocab']`` with the last two of each
    row padding, unit values (scores are small integers: many ties)."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.integers(0, SPARSE["vocab"], (rows, SPARSE["k_dims"])),
                  axis=1)
    idx[:, -2:] = 0xFFFFFFFF
    val = np.where(idx == 0xFFFFFFFF, 0.0, 1.0).astype(np.float32)
    return idx.astype(np.int64), val


def _pair_rows(rows: int, seed: int) -> dict:
    """Arxiv feature rows: dense:text f32 [rows, 128], scalar:year."""
    rng = np.random.default_rng(seed)
    return {"dense:text": rng.normal(size=(rows, 128)).astype(np.float32),
            "scalar:year": rng.integers(1990, 2021, rows).astype(np.float32)}


def _scorer_params(f: int) -> dict:
    rng = np.random.default_rng(3)
    dims = [f, 10, 10, 1]
    out = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = rng.normal(size=(d_in, d_out)).astype(np.float32)
        out[f"b{i}"] = rng.normal(size=(d_out,)).astype(np.float32)
    return out


def time_tree(tree: str) -> dict:
    import torch
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.kernels import _build, fused_query, ops, topk_select

    _build.build_all()
    dev = torch.device("cuda")

    def ms(fn) -> float:
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

    def device_profile(fn, reps: int = REPS) -> dict:
        """Device ms, kernels and copies per call (torch.profiler)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        copies = sum(e.count for e in events
                     if e.key.startswith(("Memcpy", "Memset")))
        return dict(device_ms=sum(e.self_device_time_total for e in events)
                    / 1e3 / reps,
                    device_kernels=(sum(e.count for e in events) - copies)
                    / reps,
                    device_copies=copies / reps)

    def device_ms(fn) -> float:
        return device_profile(fn)["device_ms"]

    def step_row(fn) -> dict:
        prof = device_profile(fn)
        return dict(ms=ms(fn), device_ms=prof["device_ms"],
                    host_ms=host_ms(fn),
                    device_kernels_per_call=prof["device_kernels"],
                    device_copies_per_call=prof["device_copies"])

    def host_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / REPS
        torch.cuda.synchronize()
        return host

    def same(got, want) -> bool:
        return (torch.equal(got[1], want[1])
                and torch.equal(got[0].view(torch.int32),
                                want[0].view(torch.int32)))

    signed = "signed_zeros" in inspect.signature(
        topk_select.topk_select).parameters
    out = {}
    for name, (b, n, k) in TOPK.items():
        scores = torch.as_tensor(_topk_scores(b, n)).to(dev)
        kw = {"signed_zeros": True} if signed and k > 64 else {}
        kernel = lambda: topk_select.topk_select(scores, k, **kw)  # noqa
        plain = lambda: topk_select.topk_select_plain(scores, k, **kw)  # noqa
        library = lambda: torch.topk(scores, k)  # noqa
        row = dict(kernel_ms=ms(kernel), kernel_device_ms=device_ms(kernel),
                   kernel_host_ms=host_ms(kernel), plain_ms=ms(plain),
                   torch_topk_ms=ms(library),
                   torch_topk_device_ms=device_ms(library),
                   torch_topk_host_ms=host_ms(library),
                   equal=same(kernel(), plain()))
        if k > 64:
            row["ops_route_ms"] = ms(lambda: ops.topk_select(scores, k))
        out[f"topk {name}"] = row
    for name, (b, int8) in FUSED.items():
        args = [torch.as_tensor(a).to(dev) for a in _fused_inputs(b)]
        if int8:
            args = [*ops.quantize_lut(args[0]), *args[1:]]
            kernel = lambda: fused_query.fused_query_kernel_int8(  # noqa
                *args, K_FUSED)
            plain = lambda: fused_query.fused_query_int8_plain(  # noqa
                *args, K_FUSED)
        else:
            kernel = lambda: fused_query.fused_query_kernel(  # noqa
                *args, K_FUSED)
            plain = lambda: fused_query.fused_query_plain(  # noqa
                *args, K_FUSED)
        out[f"fused {name}"] = dict(
            kernel_ms=ms(kernel), kernel_device_ms=device_ms(kernel),
            kernel_host_ms=host_ms(kernel), plain_ms=ms(plain),
            equal=same(kernel(), plain()))
    out.update(time_scorers(torch, dev, step_row))
    out.update(time_steps(torch, dev, step_row))
    out["neighborhood RPC"] = time_rpc(torch, dev, device_profile)
    return out


def time_scorers(torch, dev, step_row) -> dict:
    """The shared sparse dot, both pq-score forms and the brute search
    (module doc)."""
    from repro_torch.ann.brute import BruteIndex
    from repro_torch.core.types import SparseBatch
    from repro_torch.kernels import pq_score, sparse_dot

    def bits(a, b) -> bool:
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))

    out = {}
    q = [torch.as_tensor(a).to(dev) for a in _sparse_rows(SPARSE["b"], 1)]
    db = [torch.as_tensor(a).to(dev) for a in _sparse_rows(SPARSE["n"], 2)]
    row = step_row(lambda: sparse_dot.sparse_dot(*q, *db))
    row["equal"] = bits(sparse_dot.sparse_dot(*q, *db),
                        sparse_dot.sparse_dot_plain(*q, *db))
    out[f"sparse_dot B={SPARSE['b']} N={SPARSE['n']}"] = row
    for name, (b, n) in PQ.items():
        rng = np.random.default_rng(n + b)
        lut = torch.as_tensor(rng.normal(size=(b, 8, 256)).astype(
            np.float32)).to(dev)
        shape = (n, 8) if name == "pq_score" else (b, n, 8)
        codes = torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8)
                                ).to(dev)
        fn = getattr(pq_score, name)
        row = step_row(lambda fn=fn: fn(lut, codes))
        row["equal"] = bits(fn(lut, codes), pq_score.pq_score_plain(lut,
                                                                   codes))
        out[f"{name} B={b} N={n}"] = row
    idx, val = _sparse_rows(BRUTE["rows"], 3)
    index = BruteIndex(SPARSE["k_dims"], device=dev)
    index.upsert(np.arange(BRUTE["rows"]), SparseBatch(
        torch.as_tensor(idx).to(dev), torch.as_tensor(val).to(dev)))
    index.delete(np.arange(0, 2 * BRUTE["deleted"], 2))
    qi, qv = (torch.as_tensor(a).to(dev)
              for a in _sparse_rows(BRUTE["queries"], 4))
    search = lambda: index.search(SparseBatch(qi, qv), BRUTE["k"])  # noqa
    row = step_row(search)
    ids, dists = search()
    row.update(capacity=index.capacity, answer=dict(
        ids=ids.tolist(), dist_bits=dists.view(np.int32).tolist()))
    out[f"BruteIndex.search {BRUTE['queries']} queries k={BRUTE['k']}"] = row
    return out


def time_steps(torch, dev, step_row) -> dict:
    """The index's query step and the pair scoring step (module doc)."""
    import inspect as _inspect

    from repro_torch.ann import scann
    from repro_torch.core import scorer
    from repro_torch.data.synthetic import OGB_ARXIV_LIKE

    out = {}
    state = _index_state()
    on_dev = {k: torch.as_tensor(v).to(dev) for k, v in state.items()}
    kw = dict(nprobe=INDEX["nprobe"], reorder=INDEX["reorder"], k=INDEX["k"])
    for b in QUERY_STEP:
        q = {k: torch.as_tensor(v).to(dev) for k, v in _queries(b).items()}

        def step(q=q):
            return scann._query_step(*q.values(), *on_dev.values(), **kw)

        row = step_row(step)
        # the card's step against the same step on the CPU (plain)
        cpu = scann._query_step(
            *[torch.as_tensor(v) for v in _queries(b).values()],
            *[torch.as_tensor(v) for v in state.values()], **kw)
        got = step()
        row["equal"] = bool(
            torch.equal(got[0].cpu(), cpu[0])
            and torch.equal(got[1].cpu().view(torch.int32),
                            cpu[1].view(torch.int32)))
        out[f"_query_step B={b}"] = row
    b = QUERY_STEP[0]
    q = {k: torch.as_tensor(v).to(dev) for k, v in _queries(b).items()}
    unfused = dict(kw, fused=False)
    row = step_row(lambda: scann._query_step(*q.values(), *on_dev.values(),
                                             **unfused))
    cpu = scann._query_step(
        *[torch.as_tensor(v) for v in _queries(b).values()],
        *[torch.as_tensor(v) for v in state.values()], **unfused)
    got = scann._query_step(*q.values(), *on_dev.values(), **unfused)
    row["equal"] = bool(torch.equal(got[0].cpu(), cpu[0])
                        and torch.equal(got[1].cpu().view(torch.int32),
                                        cpu[1].view(torch.int32)))
    out[f"_query_step fused=False B={b}"] = row
    spec = OGB_ARXIV_LIKE.spec
    params = {k: torch.as_tensor(v).to(dev)
              for k, v in _scorer_params(3).items()}
    grouped = "group" in _inspect.signature(scorer.score_pairs).parameters
    for name, (nq, group) in PAIRS.items():
        fq, fc = _pair_rows(nq, nq), _pair_rows(nq * group, nq + 1)
        rep = {k: np.repeat(v, group, axis=0) for k, v in fq.items()}
        aligned = lambda: scorer.score_pairs(params, rep, fc, spec)  # noqa
        if grouped:
            rpc = lambda: scorer.score_pairs(  # noqa
                params, fq, fc, spec, group=group)
        else:
            rpc = lambda: scorer.score_pairs(  # noqa
                params, {k: np.repeat(v, group, axis=0)
                         for k, v in fq.items()}, fc, spec)
        cpu = scorer.score_pairs({k: v.cpu() for k, v in params.items()},
                                 rep, fc, spec)
        for label, fn in (("aligned", aligned), ("rpc", rpc)):
            row = step_row(fn)
            row["equal"] = bool(torch.allclose(fn().cpu(), cpu, rtol=1e-5,
                                               atol=1e-6))
            out[f"score_pairs {name} {label}"] = row
    return out


def time_rpc(torch, dev, device_profile) -> dict:
    """The neighborhood RPC of 16 ids on the chip_smoke.py main-path
    engine at the arxiv node count: wall, device time, kernels and copies
    per RPC (median wall of 8 RPCs, then 8 more under torch.profiler,
    after 2 set-up RPCs), and the answer (ids, weights) to the first
    set-up RPC, which ``main`` compares between turns."""
    import dataclasses

    from repro_torch.ann.scann import ScannConfig
    from repro_torch.core.buckets import BucketConfig
    from repro_torch.core.gus import DynamicGUS, GusConfig
    from repro_torch.core.scorer import train_scorer
    from repro_torch.data.stream import MutationStream, StreamConfig
    from repro_torch.data.synthetic import (OGB_ARXIV_LIKE, OGB_ARXIV_NODES,
                                            labeled_pairs, make_dataset)

    n_points = OGB_ARXIV_NODES
    data = dataclasses.replace(OGB_ARXIV_LIKE, n_points=n_points)
    cfg = GusConfig(scann_nn=10, scann=ScannConfig(
        d_proj=64, n_partitions=max(16, n_points // 256), nprobe=8,
        reorder=128))
    _, feats, cluster = make_dataset(data)
    pf, lbl = labeled_pairs(feats, cluster, min(4 * n_points, 20_000),
                            data.spec, seed=0)
    stream = MutationStream(data, StreamConfig(seed=0),
                            bootstrap_fraction=0.6)
    scorer, _ = train_scorer(0, data.spec, pf, lbl, steps=300, device=dev)
    gus = DynamicGUS(data.spec, BucketConfig(
        dense_tables=8, dense_bits=10, set_tables=6, scalar_widths=(2.0,)),
        scorer, cfg, device=dev)
    gus.bootstrap(*stream.bootstrap())
    answer = gus.neighbors_of_ids(stream.query_ids(16))
    gus.neighbors_of_ids(stream.query_ids(16))
    walls = []
    for _ in range(8):
        qids = stream.query_ids(16)
        t0 = time.perf_counter()
        gus.neighbors_of_ids(qids)          # results come back to the host
        walls.append((time.perf_counter() - t0) * 1e3)
    work = iter([stream.query_ids(16) for _ in range(9)])
    prof = device_profile(lambda: gus.neighbors_of_ids(next(work)), reps=8)
    return dict(points=n_points, slab=gus.index.slab,
                wall_p50_ms=float(np.median(walls)),
                device_ms=prof["device_ms"],
                device_kernels_per_rpc=prof["device_kernels"],
                device_copies_per_rpc=prof["device_copies"],
                answer=dict(ids=answer.ids.tolist(),
                            weights=answer.weights.tolist()))


def _same_answer(got: dict, want: dict) -> bool:
    """Ids exactly, weights within pair_score's tolerance (-inf pads
    equal)."""
    return (np.array_equal(got["ids"], want["ids"])
            and np.allclose(got["weights"], want["weights"], rtol=1e-5,
                            atol=1e-6))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", help="time one tree (a turn)")
    ap.add_argument("--a", help="tree A (the parent)")
    ap.add_argument("--b", help="tree B (the change)")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_tree(args.time)))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    turns = []
    for label, tree in (("A", args.a), ("B", args.b), ("B", args.b),
                        ("A", args.a)):
        proc = subprocess.run([sys.executable, __file__, "--time", tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append(dict(tree=label, path=tree, times=times))
        shown = {name: {k: v for k, v in row.items() if k != "answer"}
                 for name, row in times.items()}
        print(f"[ab] turn {len(turns)} ({label}): " + json.dumps(shown))
    rpcs = [t["times"]["neighborhood RPC"] for t in turns]
    answers = [row.pop("answer") for row in rpcs]
    for i, row in enumerate(rpcs):
        row["equal"] = _same_answer(answers[i], answers[-1 if i == 0 else 0])
    brute = f"BruteIndex.search {BRUTE['queries']} queries k={BRUTE['k']}"
    answers = [t["times"][brute].pop("answer") for t in turns]
    for i, t in enumerate(turns):
        t["times"][brute]["equal"] = (answers[i]
                                      == answers[-1 if i == 0 else 0])
    bad = [(t["tree"], name) for t in turns for name, row in t["times"].items()
           if not row["equal"]]
    result = dict(card=card, turns=turns, kernels_equal_plain=not bad)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
