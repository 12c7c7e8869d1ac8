"""The dry-run's GUS cells, run on the card (port of the GUS half of
``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --gus [--gus-mutate | --gus-delete]
        [--gus-merge hier] [--multipod | --both-meshes] [--gus-shards N]
        [--device cpu] [--check] --out results/dryrun

The reference lowers and compiles the sharded query, mutate and delete
steps (``ann/sharded.py``) for the production pod meshes, and reads XLA's
memory analysis, cost analysis and HLO collectives. The port has no
compiler to ask: it builds the cell's state on the device at full size
(``ann.sharded.seeded_cell``; the default cell, ``gus_serve_100m``, is
4,096 partitions x 8,192 slots, about 7.2 GB, which one H100 holds
whole), runs the step, and writes the same record with the device's own
numbers:

* ``memory``: ``argument_bytes`` (shard 0's state plus the step's inputs:
  the reference's per-device figure), ``output_bytes`` (shard 0's share
  of what the step returns, plus its replicated outputs),
  ``temp_bytes`` (the peak allocated during one step less what was
  allocated before it, after ``torch.cuda.reset_peak_memory_stats``),
  ``peak_bytes`` (that peak) and ``code_bytes`` (the size of the kernel
  libraries the step launched); 0 for the last three on the CPU;
* ``flops`` and ``bytes_accessed``: counted from the cell's shapes by
  ``step_cost`` (XLA's cost analysis has no counterpart);
* ``collectives``: the bytes the step's explicit gathers and sums move,
  counted from the cell's and the mesh's shapes by ``collectives``
  (the reference reads them from the HLO);
* ``build_s`` (state allocation and fill) and ``first_call_s`` (the first
  step, kernel loads included) where the reference has ``lower_s`` and
  ``compile_s``; ``step_ms``, the median of ``runs`` steps after the
  first, each timed by CUDA events (by the host clock on the CPU);
  ``device``, the card's name and power limit as ``nvidia-smi`` gives
  them (``"cpu"`` on the CPU); and with ``profile`` on the card, one
  more step under ``torch.profiler``: device busy ms, idle share and the
  kernels with the most device time (off by default: it costs one more
  step and the profiler's host time).

With ``check`` the record also holds ``check``, and the call raises if it
fails: the query's first 64 rows and distances equal, bit for bit, the
same step's on CPU copies of every shard's state, and at least 90% of the
returned distances are finite and nonzero; every mutated id is read back
from the one site the mutate step reported, each partition's cursor moved
by the rows it received and no other slot changed; the delete step
cleared exactly the ``valid`` bits of the sites a mutate step reported.

The architecture cells (``--arch``, ``--shape``) reach the LM tower, which
is not ported: they exit non-zero. Importing this module touches no device
and sets no environment variable (the reference's sets ``XLA_FLAGS``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.ann import sharded
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_gus_mesh, make_production_mesh
from repro_torch.utils.device import resolve

LM_CELLS = ("the architecture cells (--arch/--shape) are not ported: the "
            "LM tower's dense serving path is (configs/, models/, "
            "serve/serve_step.py), but the cells wait for ROADMAP.md "
            "Queue 1 item 5.4 (launch/sharding.py, the specs, run_cell)")
CHECK_QUERIES = 64


def gus_cell(n_partitions: int = 4096, slab: int = 8192, merge: str = "flat",
             shards: int = 0) -> sharded.GusCellConfig:
    """The cell of ``run_gus_cell``: the default ``GusCellConfig`` at
    ``n_partitions`` x ``slab``, or, with ``shards > 0``, the reference's
    shrink for a small 1-D mesh (the partitions cut to ``shards * 16`` and
    rounded up to a multiple of ``shards``, slabs to at most 1,024,
    batches of 64 queries and 256 mutations)."""
    cell = sharded.GusCellConfig(merge=merge, n_partitions=n_partitions,
                                 slab=slab)
    if not shards:
        return cell
    c = min(n_partitions, shards * 16)
    c = (c + shards - 1) // shards * shards
    return dataclasses.replace(cell, n_partitions=c, slab=min(slab, 1024),
                               query_batch=64, mutate_batch=256)


def gus_kind(op: str, merge: str, tag: str) -> str:
    kind = f"gus_{op}"
    if merge != "flat":
        kind = f"{kind}_{merge}"
    return f"{kind}_{tag}" if tag else kind


def _shortlist(cell: sharded.GusCellConfig) -> tuple[int, int]:
    """(r, k_loc): a shard's shortlist length and its local top-k, as the
    query step sizes them."""
    r = min(cell.reorder if cell.reorder > 0 else 2 * cell.top_k,
            cell.nprobe_local * cell.slab)
    return r, min(cell.top_k, r)


def step_cost(op: str, cell: sharded.GusCellConfig, n_shards: int
              ) -> tuple[float, float]:
    """(flops, bytes_accessed) of one step over every shard, from the
    cell's shapes (n shards, C_loc = C / n partitions each, slab S, batch
    B, K sparse dims, d sketch dims, M subspaces of C_pq centers, P =
    nprobe_local, r the shortlist, k = top_k):

    * query: flops n * (2 B d C_loc [partition scores] + 2 B C_pq d [LUT]
      + B P S (M + 1) [PQ sums and bias] + 2 B r K^2 [exact rescore]);
      bytes n * (4 C_loc d + 4 C_pq d [centroids, books] + 12 B K
      + 4 B d [queries] + B P S (M + 1 + 4) [codes, valid, ids of the
      probed slabs] + 12 B r K [the shortlist's rows] + 12 B k [the local
      top-k]) + 12 B k [the answer];
    * mutate: flops n * 3 B d C_loc (distances to the local centroids);
      bytes n * (4 C_loc d + B (8 + 12 K + 4 d + M)) [every shard reads
      the batch] + B (12 K + M + 5) [the rows written] + 16 B [routes];
    * delete: no flops; bytes n * 16 B [every shard reads the pairs] + B
      [the bits cleared]."""
    n, b, k_d, d = n_shards, cell.query_batch, cell.k_dims, cell.d_proj
    c_loc, s, m, c_pq = (cell.n_partitions // n_shards, cell.slab,
                         cell.pq_m, cell.pq_centers)
    if op == "query":
        p = cell.nprobe_local
        r, k = _shortlist(cell)
        flops = n * (2 * b * d * c_loc + 2 * b * c_pq * d
                     + b * p * s * (m + 1) + 2 * b * r * k_d * k_d)
        nbytes = n * (4 * c_loc * d + 4 * c_pq * d + 12 * b * k_d + 4 * b * d
                      + b * p * s * (m + 5) + 12 * b * r * k_d
                      + 12 * b * k) + 12 * b * cell.top_k
        return float(flops), float(nbytes)
    bm = cell.mutate_batch
    if op == "mutate":
        return (float(n * 3 * bm * d * c_loc),
                float(n * (4 * c_loc * d + bm * (8 + 12 * k_d + 4 * d + m))
                      + bm * (12 * k_d + m + 5) + 16 * bm))
    return 0.0, float(n * 16 * bm + bm)


def collectives(op: str, cell: sharded.GusCellConfig, mesh) -> dict:
    """The explicit collectives of one step over ``mesh``, in the summary
    form of the reference's ``utils/hlo.py::collective_stats``
    (``total_bytes``, ``bytes_by_op``, ``count_by_op``). One op is one
    collective of the reference's program; its bytes are every shard's
    operand (the reference counts one device's). With n shards, batch B,
    the local top-k k_loc = min(top_k, r) and n_model shards on the last
    mesh axis:

    * query, flat: two all-gathers of every shard's top-k, scores f32 and
      rows int64: 12 n B k_loc bytes;
    * query, hier (on a mesh of two or more axes; a 1-D mesh merges
      flat): those two within each group of n_model consecutive
      shards, then two more of the n / n_model groups' top-k: 12 n B
      k_loc + 12 (n / n_model) B top_k bytes;
    * mutate: two all-reduces (sums) of every shard's routes, int64 [B
      n_copies] each: 16 n B n_copies bytes;
    * delete: none (the tombstones come replicated)."""
    n = mesh.size
    by_op, count = {}, {}
    if op == "query":
        b, k_loc = cell.query_batch, _shortlist(cell)[1]
        by_op["all-gather"] = 12 * n * b * k_loc
        count["all-gather"] = 2
        if cell.merge == "hier" and len(mesh.axis_names) > 1:
            by_op["all-gather"] += 12 * (n // mesh.shape[-1]) * b * cell.top_k
            count["all-gather"] += 2
    elif op == "mutate":
        by_op["all-reduce"] = 16 * n * cell.mutate_batch * cell.n_copies
        count["all-reduce"] = 2
    return {"total_bytes": sum(by_op.values()), "bytes_by_op": by_op,
            "count_by_op": count}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_ms(call, dev: torch.device) -> float:
    """One call's time: CUDA events on the card, the host clock on the
    CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        call()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end)


def _profile(call, dev: torch.device) -> dict:
    """One more step under ``torch.profiler`` (CPU and CUDA activity):
    its wall ms (the profiler's host overhead included), the device's busy
    ms (its kernels and copies), the idle share between them, and the
    eight kernel names (their first 60 characters, so the instances of
    one template sum together) with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    if not events:
        # it drops device records, more the older the process is
        raise RuntimeError("torch.profiler kept no device record of the "
                           "step: profile in a fresh process")
    by_name: dict[str, float] = {}
    for e in events:
        name = e.key[:60]
        by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total / 1e3
    busy = sum(by_name.values())
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall,
            "top_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])}


def _cpu_twin(mesh):
    return dataclasses.replace(mesh, devices=(torch.device("cpu"),)
                               * mesh.size)


def check_query(mesh, cell, states, inputs, out) -> dict:
    """The first ``CHECK_QUERIES`` queries' rows and distances equal, bit
    for bit, the same step's on CPU copies of every shard's state (a host
    copy of the whole index), and at least 90% of all the returned
    distances are finite and nonzero."""
    n = min(CHECK_QUERIES, cell.query_batch)
    cpu_states = [{key: t.cpu() for key, t in st.items()} for st in states]
    rows, dists = sharded.make_query_step(_cpu_twin(mesh), cell)(
        *(t[:n].cpu() for t in inputs), cpu_states)
    del cpu_states
    got_rows, got_d = out[0][:n].cpu(), out[1][:n].cpu()
    if not (torch.equal(rows, got_rows)
            and torch.equal(dists.view(torch.int32), got_d.view(torch.int32))):
        raise AssertionError(f"the query step's first {n} answers differ "
                             f"from the same step on the CPU copies")
    live = float((torch.isfinite(out[1]) & (out[1] != 0)).float().mean())
    if live < 0.9:
        raise AssertionError(f"only {live:.3f} of the distances are finite "
                             f"and nonzero")
    return {"queries_compared": n, "bitwise": True,
            "finite_nonzero_share": live}


def _sites(mesh, cell, parts, poss):
    """Per shard: (local partition, slot) of the global sites it owns."""
    c_loc = cell.n_partitions // mesh.size
    out = []
    for i, dev in enumerate(mesh.devices):
        mine = ((parts >= i * c_loc) & (parts < (i + 1) * c_loc)).nonzero()[:, 0]
        out.append((mine, (parts[mine] - i * c_loc).to(dev),
                    poss[mine].to(dev)))
    return out


def check_mutate(mesh, cell, before, states, inputs, routes) -> dict:
    """Every id of the batch landed on exactly one shard: each reported
    (partition, slot) holds the id and its ``members_idx``,
    ``members_val`` and ``codes``, live; each partition's cursor grew by
    exactly the rows it received; and no other slot changed (``before``
    holds each shard's mutable arrays before the step)."""
    ids, new_idx, new_val, _, new_codes = inputs
    parts, poss = routes[0].reshape(-1), routes[1].reshape(-1)
    if cell.n_copies != 1 or bool((parts < 0).any()):
        raise AssertionError("a mutated row landed nowhere")
    c_loc, s = cell.n_partitions // mesh.size, cell.slab
    landed = 0
    for (mine, lp, ps), st, old in zip(_sites(mesh, cell, parts, poss),
                                       states, before):
        dev = st["valid"].device
        mine_d = mine.to(dev)
        want = {"row_ids": ops._as_int32_bits(ids.to(dev)[mine_d]),
                "members_idx": new_idx.to(dev)[mine_d],
                "members_val": new_val.to(dev)[mine_d],
                "codes": new_codes.to(dev)[mine_d]}
        for key, value in want.items():
            if not torch.equal(st[key][lp, ps], value):
                raise AssertionError(f"a reported site does not hold its "
                                     f"row's {key}")
        if not bool(st["valid"][lp, ps].all()):
            raise AssertionError("a reported site is not live")
        grew = torch.bincount(lp, minlength=c_loc).to(torch.int32)
        if not torch.equal(st["counts"] - old["counts"], grew):
            raise AssertionError("a cursor moved by another count than the "
                                 "rows its partition received")
        expected = torch.zeros((c_loc, s), dtype=torch.bool, device=dev)
        expected[lp, ps] = True
        if int(expected.sum()) != len(mine):
            raise AssertionError("two rows were reported at one site")
        changed = torch.zeros_like(expected)
        for key in ("members_idx", "members_val", "codes", "row_ids",
                    "valid"):
            diff = st[key] != old[key]
            changed |= diff.flatten(2).any(2) if diff.dim() == 3 else diff
        if bool((changed & ~expected).any()):
            raise AssertionError("a slot outside the reported sites changed")
        landed += len(mine)
    if landed != len(parts):
        raise AssertionError(f"{landed} of {len(parts)} rows landed")
    return {"rows": landed, "read_back": True}


def check_delete(mesh, cell, before_valid, states, parts, poss) -> dict:
    """The delete step cleared exactly the ``valid`` bits of the given
    sites (all live before it) and no other."""
    cleared = 0
    for (mine, lp, ps), st, old in zip(_sites(mesh, cell, parts, poss),
                                       states, before_valid):
        if not bool(old[lp, ps].all()):
            raise AssertionError("a tombstoned site was not live")
        want = old.clone()
        want[lp, ps] = False
        if not torch.equal(st["valid"], want):
            raise AssertionError("the delete step's valid bits differ from "
                                 "the tombstoned sites")
        cleared += int((old != st["valid"]).sum())
    if cleared != len(parts):
        raise AssertionError(f"{cleared} bits cleared for {len(parts)} "
                             f"sites")
    return {"cleared": cleared}


def run_gus_cell(multi_pod: bool, out_dir: str = "results/dryrun",
                 op: str = "query", merge: str = "flat",
                 n_partitions: int = 4096, slab: int = 8192, tag: str = "",
                 shards: int = 0, device=None, runs: int = 5,
                 check: bool = False, profile: bool = False) -> dict:
    """One GUS cell: the sharded query, mutate or delete step built at the
    cell's size on ``device`` (``None``: the card) over the production
    mesh (16x16, or 2x16x16 with ``multi_pod``), or with ``shards > 0``
    over the small 1-D mesh of the reference's shrunk cell; run once, then
    ``runs`` times timed; the record (module docstring) written to
    ``out_dir`` and returned. A delete cell tombstones the sites of one
    mutate step run first (as set-up). ``check`` and ``profile``: see
    the module docstring."""
    if op not in ("query", "mutate", "delete"):
        raise ValueError(f"unknown GUS op {op!r}")
    dev = resolve(device)
    cell = gus_cell(n_partitions, slab, merge, shards)
    if shards:
        mesh = make_gus_mesh(shards, device=dev)
        mesh_name = f"cpu{shards}"
    else:
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": "dynamic-gus", "shape": cell.name, "mesh": mesh_name,
           "kind": gus_kind(op, merge, tag), "shards": mesh.size,
           "device": _card_line() if dev.type == "cuda" else "cpu"}
    _sync(dev)
    t0 = time.perf_counter()
    states, inputs = sharded.seeded_cell(cell, mesh)
    if op == "query":
        step = sharded.make_query_step(mesh, cell)
        args = inputs["query"]
    elif op == "mutate":
        step = sharded.make_mutate_step(mesh, cell)
        args = inputs["mutate"]
    else:
        _, routes = sharded.make_mutate_step(mesh, cell)(*inputs["mutate"],
                                                         states)
        step = sharded.make_delete_step(mesh, cell)
        args = tuple(r.reshape(-1) for r in routes)
    _sync(dev)
    rec["build_s"] = round(time.perf_counter() - t0, 3)

    def call():
        return step(*args, states)

    before = None
    if check and op == "mutate":
        before = [{key: st[key].clone() for key in sharded.MUTABLE}
                  for st in states]
    elif check and op == "delete":
        before = [st["valid"].clone() for st in states]
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    out = call()
    _sync(dev)
    rec["first_call_s"] = round(time.perf_counter() - t0, 3)
    launched = {name for name, n in ops.launch_counts().items()
                if n > counts[name]}
    if check:
        if op == "query":
            rec["check"] = check_query(mesh, cell, states, args, out)
        elif op == "mutate":
            rec["check"] = check_mutate(mesh, cell, before, states, args,
                                        out[1])
        else:
            rec["check"] = check_delete(mesh, cell, before, states, *args)
        del before

    # one more step between a reset of the peak and its read
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = call()
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    step_ms = [_timed_ms(call, dev) for _ in range(runs)]
    if profile and dev.type == "cuda":
        rec["profile"] = _profile(call, dev)

    replicated = out if op == "query" else out[1] if op == "mutate" else ()
    if op == "query":
        shard_out = []
    elif op == "mutate":
        shard_out = [states[0][key] for key in sharded.MUTABLE]
    else:
        shard_out = [states[0]["valid"]]
    flops, nbytes = step_cost(op, cell, mesh.size)
    rec.update(
        step_ms=statistics.median(step_ms) if step_ms else None, runs=runs,
        main={"memory": {
                  "argument_bytes": _nbytes([*states[0].values(), *args]),
                  "output_bytes": _nbytes([*shard_out, *replicated]),
                  "temp_bytes": max(peak - base, 0), "peak_bytes": peak,
                  "code_bytes": sum(_build.library_bytes(lib) for lib in
                                    {ops.KERNELS[name].__module__.rsplit(
                                        ".", 1)[-1] for name in launched})},
              "flops": flops, "bytes_accessed": nbytes,
              "collectives": collectives(op, cell, mesh)})
    _write(out_dir, rec)
    return rec


def _write(out_dir: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['kind']}_{rec['mesh']}"
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    mem = rec["main"]["memory"]
    print(f"[dryrun] {name}: OK (build {rec['build_s']} s, first call "
          f"{rec['first_call_s']} s, step {rec['step_ms']} ms, temp_bytes "
          f"{mem['temp_bytes']}, peak {mem['peak_bytes'] / 1e9:.3f} GB, "
          f"{rec['device']})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help=LM_CELLS)
    ap.add_argument("--shape", default=None, help=LM_CELLS)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--gus", action="store_true",
                    help="run the sharded-GUS paper cells")
    ap.add_argument("--gus-mutate", action="store_true")
    ap.add_argument("--gus-delete", action="store_true")
    ap.add_argument("--gus-merge", default="flat", choices=("flat", "hier"))
    ap.add_argument("--gus-partitions", type=int, default=4096)
    ap.add_argument("--gus-slab", type=int, default=8192)
    ap.add_argument("--gus-tag", default="")
    ap.add_argument("--gus-shards", type=int, default=0,
                    help="run the GUS cells, shrunk, on an N-shard 1-D "
                         "mesh instead of the pod mesh")
    ap.add_argument("--device", default=None,
                    help="the device of every shard (default: the card)")
    ap.add_argument("--runs", type=int, default=5,
                    help="timed steps after the first")
    ap.add_argument("--check", action="store_true",
                    help="check each step's answer (module docstring)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more step on the card")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    if args.arch is not None or args.shape is not None or not (
            args.gus or args.gus_mutate or args.gus_delete):
        ap.exit(2, f"dryrun: {LM_CELLS}; run the GUS cells with --gus, "
                   f"--gus-mutate or --gus-delete\n")
    op = ("mutate" if args.gus_mutate
          else "delete" if args.gus_delete else "query")
    for mp in ([False, True] if args.both_meshes else [args.multipod]):
        run_gus_cell(mp, args.out, op=op, merge=args.gus_merge,
                     n_partitions=args.gus_partitions, slab=args.gus_slab,
                     tag=args.gus_tag, shards=args.gus_shards,
                     device=args.device, runs=args.runs, check=args.check,
                     profile=args.profile)


if __name__ == "__main__":
    sys.exit(main())
