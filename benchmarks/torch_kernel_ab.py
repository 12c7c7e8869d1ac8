"""Times of the top-k and fused-shortlist kernels of two trees of
the PyTorch/CUDA port, measured in turns on one card (A B B A), for
comparing a change with its parent in one run:

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
tree's plain version. The last line is the JSON of all turns with the
card's name and power limit. Imports nothing of JAX.
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

    def device_ms(fn) -> float:
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
    return out


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
        print(f"[ab] turn {len(turns)} ({label}): " + json.dumps(times))
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
