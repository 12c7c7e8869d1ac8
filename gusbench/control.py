"""Readings for the limits of a cell's comparison: for each seed, one run
of the cell (set-up, a window of ``--seconds``) judged twice, once on the
program's outputs and once with the control, the plain reference in
bfloat16, in the program's place. The control has to fail.

    python3 gusbench/control.py --workload arxiv-index.reads \\
        --seeds 11,12,13 --seconds 10 [--out control.json]

All seeds run in this one process. Prints one JSON line per seed with
both sets of numbers; run from the root of a checkout.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(ROOT / "src"))

from harness.runner import Run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--override", default=None,
                    help="JSON merged into the cell's files, e.g. "
                         '\'{"config": {"index": {"nprobe": 4}}}\'')
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    over = json.loads(args.override) if args.override else None
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run = Run(ROOT, args.workload, seed, device=args.device,
                  overrides=over)
        reqs = run.setup(args.seconds)
        run.measure(reqs, args.seconds, False)
        mine, ctrl = run.judge(both=True)
        row = {"seed": seed,
               "program": {n: v for n, v, _ in mine},
               "program_correct": all(v <= lim for _, v, lim in mine),
               "control": {n: v for n, v, _ in ctrl},
               "control_correct": all(v <= lim for _, v, lim in ctrl),
               "limits": {n: lim for n, _, lim in mine}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0 if all(r["program_correct"] and not r["control_correct"]
                    for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
