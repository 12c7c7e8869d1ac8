"""Find the knee of an open-loop cell: one set-up, then one window at
each offered rate, in increasing order, on the state the earlier windows
left.

    python3 gusbench/sweep.py --workload arxiv-index.reads --seed 7 \\
        --seconds 15 --rates 60,80,100,120,140 [--out sweep.json]

Prints one JSON line per rate: the neighborhood (and any mutation) RPCs'
percentiles from the due time, and how far behind schedule the server
was in the first and the last quarter of the window (a backlog that grows
over the window shows as a last quarter far behind the first). The knee
is the highest rate below which every rate swept keeps the neighborhood
p95 at or under the limit (``--p95-limit-ms``, 50) without a growing
backlog. Every window is then
checked by the cell's comparison. Run from the root of a checkout.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path.cwd()
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(ROOT / "src"))

from harness import readers  # noqa: E402
from harness.runner import Run, merge  # noqa: E402


def summary(run: readers.RunData, rate: float) -> dict:
    q = readers.latencies_ms(run, "query")
    m = readers.latencies_ms(run, "mutate")
    behind = np.asarray([r["start"] - r["due"] for r in run.requests]) * 1e3
    quarter = max(1, behind.size // 4)
    out = {"rate_per_s": rate, "requests": len(run.requests),
           "query_p50_ms": float(np.percentile(q, 50)),
           "query_p95_ms": float(np.percentile(q, 95)),
           "query_p99_ms": float(np.percentile(q, 99))}
    if m.size:
        out["mutate_p50_ms"] = float(np.percentile(m, 50))
        out["mutate_p95_ms"] = float(np.percentile(m, 95))
    return {**out,
            "behind_first_quarter_ms": float(behind[:quarter].mean()),
            "behind_last_quarter_ms": float(behind[-quarter:].mean()),
            "service_ms": float(np.mean([r["end"] - r["start"]
                                         for r in run.requests]) * 1e3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--p95-limit-ms", type=float, default=50.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rates = [float(r) for r in args.rates.split(",")]
    run = Run(ROOT, args.workload, args.seed, device=args.device)
    if run.traffic["loop"] != "open":
        raise SystemExit("the sweep is for open-loop cells")
    run.setup(0.0)
    rows = []
    for rate in rates:
        run.plan.traffic = merge(run.traffic, {"rate_per_s": rate})
        reqs = run.plan.window(args.seconds)
        data = run.measure(reqs, args.seconds, False)[0]
        row = summary(data, rate)
        row["knee_ok"] = bool(
            row["query_p95_ms"] <= args.p95_limit_ms
            and row["behind_last_quarter_ms"]
            <= row["behind_first_quarter_ms"] + args.p95_limit_ms / 2)
        rows.append(row)
        print(json.dumps(row), flush=True)
    knee = None
    for r in rows:
        if not r["knee_ok"]:
            break
        knee = r["rate_per_s"]
    checks = run.judge()
    out = {"knee_per_s": knee, "rows": rows,
           "correct": all(v <= lim for _, v, lim in checks),
           "checks": {n: [v, lim] for n, v, lim in checks}}
    print(json.dumps({k: out[k] for k in ("knee_per_s", "correct",
                                          "checks")}))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
