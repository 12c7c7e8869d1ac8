"""Run one cell of the benchmark once and print its result line.

    python3 gusbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: it reads ``BENCHMARK.json`` there and
drives the program in ``src/repro_torch`` on the CUDA card. The last line
of standard output is the result (JSON); the last lines of standard error
are the numbers compared, each beside its limit. Exit codes: 0 a result
was printed; 2 no card (or fewer than the cell asks for); 3 the program
or the benchmark's files could not be loaded; 4 a forbidden module (JAX
or the JAX package) was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
BENCH = Path(__file__).resolve().parent


def _env() -> None:
    """Caches at fixed paths inside the checkout, few host threads, and no
    JAX behind any library the program loads."""
    cache = ROOT / ".gusbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT / "src"))
    import torch
    try:
        chips = next(w["chips"] for w in json.loads(
            (ROOT / "BENCHMARK.json").read_text())["workloads"]
            if w["name"] == args.workload)
    except (OSError, StopIteration, KeyError, ValueError) as exc:
        print(f"[gusbench] cannot read the cell: {exc!r}", file=sys.stderr)
        return 3
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[gusbench] needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
        from harness.runner import forbidden_modules, run_cell
    except ImportError as exc:
        print(f"[gusbench] cannot load the program: {exc!r}", file=sys.stderr)
        return 3
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"[gusbench] forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for m in out["metrics"].values():
        if not math.isfinite(m["value"]):
            # a tail that an unanswered request reaches: the largest float,
            # so the line stays JSON (and ``correct`` is already false)
            m["value"] = sys.float_info.max
    extra = out.pop("_extra")
    print("[gusbench] " + json.dumps(extra), file=sys.stderr)
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} <= {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
