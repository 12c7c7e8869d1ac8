"""The multi-pod dry-run (port of ``repro/launch/dryrun.py``): the GUS
cells, run on the card, and the architecture cells, sized on the meta
device and run whole on the card where one card holds them.

    python -m repro_torch.launch.dryrun --gus [--gus-mutate | --gus-delete]
        [--gus-merge hier] [--multipod | --both-meshes] [--gus-shards N]
        [--device cpu] [--check] --out results/dryrun
    python -m repro_torch.launch.dryrun [--arch ID|all] [--shape NAME]
        [--multipod | --both-meshes] [--no-probes | --probes-only]
        [--device cpu] [--check] --out results/dryrun

**The GUS cells.** The reference lowers and compiles the sharded query, mutate and delete
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

**The architecture cells** (every arch of ``configs/registry.py`` x every
shape of ``configs/base.py::SHAPES`` x the 16x16 and 2x16x16 meshes; with
neither ``--gus*`` nor ``--arch`` the sweep runs shape-major over all of
them, as the reference's does). The reference compiles each step for the
mesh and reads XLA's analyses. The port has no compiler to ask, and most
cells do not fit one card (jamba's params are 797 GB, command-r-plus's
decode cache 1.1 TB), so every live cell is sized on the meta device:

* ``memory``: ``argument_bytes`` and ``output_bytes`` are what one device
  of the mesh holds of the step's inputs and outputs under the sharding
  policy (``launch/sharding.py``: params, opt state and batch in train;
  params and batch in prefill; params, cache and tokens in decode; the
  outputs as ``_out_specs`` shards them). XLA adds 8 bytes a leaf for its
  output tuple's index table, which the port does not count.
  ``temp_bytes`` and ``code_bytes`` are ``null``: no compiler gives them;
* ``flops`` and ``bytes_accessed``: the whole unsharded step counted on
  the meta device (``launch/cost.py``: ``torch.utils.flop_counter``'s
  formulas, and every aten operator's input and output bytes, nothing
  fused, so an upper figure next to XLA's); divide by ``devices`` for the
  reference's per-device figure;
* ``collectives``: counted from the specs by ``collectives_from_specs``'s
  rule, in the ``CollectiveStats.summary()`` form;
* ``probes`` and ``corrected``: the same analysis of the reference's probe
  programs (1 and 2 layer groups, unrolled, one microbatch) and
  ``extrapolate`` over them, as the reference does. The port unrolls
  every layer, so ``corrected`` equals ``main`` where the cell has one
  microbatch. In train with n > 1 microbatches (the published configs)
  ``corrected``'s flops equal ``main``'s (a product's flops scale with
  its tokens, however they are split), while its bytes and collectives
  are lower (each microbatch reads and gathers the weights again and
  adds into the gradients);
* ``plan``: ``cell_plan``, what running the cell whole on one device
  would hold, and ``why_meta``, the figure that ruled it out.

Such a record says ``"ran": "meta"``. A cell whose plan fits
``CARD_SHARE`` of the card's memory also runs whole on the card at its
own shape (no cut to batch, width or depth), its cache filled from a
seeded generator up to ``seq_len - 1`` so that the step reads all of it
(``run_whole``); its record says ``"ran": "card"`` and adds, as the GUS
records do, ``build_s``, ``first_call_s``, ``step_ms`` (the median of
``runs`` CUDA-event-timed steps), the measured ``temp_bytes`` and
``peak_bytes`` and the ``device`` line; with ``check`` the first call is
held against the same step on CPU copies (``_check``). With ``--device
cpu`` every live cell is sized on the meta device and none runs whole. A
cell that fails is written as an ``error`` record and the sweep goes on;
the non-applicable long_500k cells are written as ``skipped``.

The architecture cells reach no GUS kernel. Importing this module touches
no device and sets no environment variable (the reference's sets
``XLA_FLAGS``).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.ann import sharded
from repro_torch.configs.base import SHAPES, applicable
from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.launch import cost
from repro_torch.launch import sharding as shp
from repro_torch.launch.mesh import make_gus_mesh, make_production_mesh
from repro_torch.launch.sharding import P
from repro_torch.models import build_model, encdec
from repro_torch.models.model import cache_specs, input_specs, params_specs
from repro_torch.models.moe import capacity
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import AdamWConfig, adamw_init, moment_dtype
from repro_torch.train.train_step import make_train_step
from repro_torch.utils.device import resolve
from repro_torch.utils.hlo import CollectiveStats
from repro_torch.utils.tree import (leaves, leaves_with_paths, tree_map,
                                    tree_param_count, tree_size_bytes)

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


# ------------------------------------------------------------ arch cells

PROBE_STACKS = {
    "dense": (1, 2), "moe": (1, 2), "vlm": (1, 2), "encdec": (1, 2),
    "ssm": (1, 2), "hybrid": (1, 2),   # in units of one layer *group*
}
CARD_SHARE = 0.85        # of the card's memory a cell's plan may use
CHECK_ROWS = 2           # batch rows the card-vs-CPU check compares
GAP_FACTOR = 4.0         # x the CPU's dtype-vs-f32 gap (phase 8's factor)
# x max(|value|, 1): the card-vs-CPU floor, the f32 bound the repo holds
# two summation orders of one model to (tests/test_models.py:111)
F32_FLOOR = 1e-3
# products whose contracted dim "model" splits: psum of their output
ROW_PARALLEL = ("wo", "x_wo", "down", "w_down", "out_proj", "down_proj",
                "shared_down")


def _group_size(cfg) -> int:
    if cfg.family == "ssm":
        return cfg.slstm_period
    if cfg.family == "hybrid":
        return cfg.attn_period
    return 1


def _probe_cfg(cfg, n_groups: int):
    """The reference's probe: ``n_groups`` layer groups, unrolled, one
    microbatch over the same global batch."""
    g = _group_size(cfg)
    repl = {"n_layers": n_groups * g, "scan_layers": False,
            "microbatches": 1}
    if cfg.family == "encdec":
        repl["n_enc_layers"] = n_groups
    return dataclasses.replace(cfg, **repl)


def opt_config(cfg) -> AdamWConfig:
    return AdamWConfig(lr=1e-4, moment_dtype=cfg.moment_dtype)


def _dp_spec(mesh, b: int):
    entry, n = shp._dp(mesh)
    return entry if b % n == 0 else None


def _cell_args(cfg, shape) -> tuple:
    """The step's inputs on the ``meta`` device: params, opt state and
    batch in train; params and batch in prefill; params, cache and the new
    tokens in decode."""
    params = params_specs(cfg)
    if shape.kind == "decode":
        return params, cache_specs(cfg, shape), \
            input_specs(cfg, shape)["tokens"]
    batch = input_specs(cfg, shape)
    if shape.kind == "prefill":
        return params, batch
    return params, adamw_init(params, opt_config(cfg)), batch


def build_cell(cfg, shape, mesh) -> dict:
    """One cell's ``args`` (``_cell_args``) and their ``arg_specs`` under
    the sharding policy on ``mesh``."""
    args = _cell_args(cfg, shape)
    p_specs = shp.param_specs(args[0], cfg, mesh)
    if shape.kind == "decode":
        specs = (p_specs, shp.cache_specs_tree(cfg, shape, mesh, args[1]),
                 P(_dp_spec(mesh, shape.global_batch)))
    else:
        b_specs = shp.batch_specs(cfg, shape, mesh, args[-1])
        specs = (p_specs, b_specs) if shape.kind == "prefill" else \
            (p_specs, shp.opt_specs(args[1], p_specs), b_specs)
    return dict(args=args, arg_specs=specs)


def _out_specs(cfg, shape, mesh, cell, out):
    """Specs of the step's outputs: train gives back params and opt state
    under their input specs, and replicated metrics; the logits (prefill's
    [B, S, Vp], decode's f32 [B, V]) split their batch over the dp axes
    and their vocab over "model" where those divide (the sharding the
    lm_head product gives them, and XLA keeps for the decode cell);
    decode's token [B] splits like the batch, and the cache keeps its
    specs."""
    if shape.kind == "train":
        return (cell["arg_specs"][0], cell["arg_specs"][1],
                {k: P() for k in out[2]})
    dp = _dp_spec(mesh, shape.global_batch)
    logits = out if shape.kind == "prefill" else out[1]
    vocab = "model" if logits.shape[-1] % shp.axis_size(
        "model", mesh) == 0 else None
    if shape.kind == "prefill":
        return P(dp, None, vocab)
    return (P(dp), P(dp, vocab), cell["arg_specs"][1])


def collectives_from_specs(cfg, shape, mesh, params, p_specs) -> dict:
    """The collectives a sharded step would run, counted from the specs
    (nothing in the port emits HLO), in ``CollectiveStats.summary()``
    form. Bytes are each collective's operand on one device, as
    ``utils/hlo.py::collective_stats`` counts them; a leaf stacked over
    [L, ...] layers is used L times. With n microbatches (1 but in
    train):

    * all-gather: every param leaf whose spec holds the FSDP axes
      ("data", or ("pod", "data")) is gathered over them before each use:
      operand its per-device shard; once a use in prefill and decode,
      twice a microbatch in train (the forward, and the backward's
      recompute of the checkpointed layers);
    * reduce-scatter (train): each of those leaves' gradients, once a
      step: operand the gradient gathered over the FSDP axes (the
      per-device shard x their device count), in the param dtype;
    * all-reduce: each row-parallel product (``ROW_PARALLEL``: wo, down,
      out_proj, ...) whose contracted dim is on "model" sums its output
      over "model": operand the output on one device, [tokens, d_out] in
      the compute dtype, tokens = the batch split over the dp axes (where
      it divides) x S (the encoder's frames for whisper's encoder, 1 in
      decode; the expert stacks [E, cap] slots a sequence); once a use in
      prefill and decode, twice a microbatch in train (the forward's psum
      and the backward's of the input gradient)."""
    stats = CollectiveStats()
    fsdp, fsdp_n = shp._dp(mesh)
    fsdp_names = fsdp if isinstance(fsdp, tuple) else (fsdp,)
    micro = max(cfg.microbatches, 1) if shape.kind == "train" else 1
    passes = 2 * micro if shape.kind == "train" else 1
    b = shape.global_batch
    b_loc = b // shp.axis_size(_dp_spec(mesh, b), mesh)
    seq = 1 if shape.kind == "decode" else shape.seq_len
    cb = cfg.cdtype.itemsize

    def add(op, nbytes, n):
        stats.bytes_by_op[op] = stats.bytes_by_op.get(op, 0) + nbytes * n
        stats.count_by_op[op] = stats.count_by_op.get(op, 0) + n

    for path, t in leaves_with_paths(params):
        spec = shp.spec_at(p_specs, path)
        keys = path.split("/")
        skip = shp._stack_depth(cfg, keys[0])
        uses = math.prod(t.shape[:skip])
        # one layer's shard: the stack dims are never sharded
        local = math.prod(shp.shard_shape(t.shape, spec, mesh)) \
            * t.element_size() // uses
        if any(e is not None and set(e if isinstance(e, tuple) else (e,))
               & set(fsdp_names) for e in spec):
            add("all-gather", local, uses * passes)
            if shape.kind == "train":
                add("reduce-scatter", local * fsdp_n, uses)
        body = tuple(spec[skip:]) + (None,) * (t.dim() - len(spec))
        if keys[-1] in ROW_PARALLEL:
            experts = keys[-1] == "w_down" and len(body) == 3
            contracted = ((1,) if experts else (0, 1)) if len(body) == 3 \
                else (0,)
            if any(body[i] == "model" for i in contracted):
                tokens = b_loc * (cfg.n_frames if keys[0] == "enc" else seq)
                if experts:           # [B, E, cap] slots a sequence
                    tokens = b_loc * t.shape[skip] * capacity(cfg, seq)
                add("all-reduce", tokens * t.shape[-1] * cb, uses * passes)
    return stats.summary()


@functools.lru_cache(maxsize=None)
def count_step(cfg, shape) -> tuple:
    """(flops, bytes, output) of the cell's step on the meta device
    (``launch/cost.py``): the whole unsharded step, so one count serves
    both meshes (divide by a mesh's device count for the reference's
    per-device figure)."""
    if shape.kind == "train":
        return cost.count_train_step(cfg, shape, opt_config(cfg))
    return cost.count(_make_step(cfg, shape), *_cell_args(cfg, shape))


def analyze(cfg, shape, mesh) -> dict:
    """The record's ``memory`` (per device, from the specs; no compiler
    gives ``temp_bytes`` and ``code_bytes``), ``flops`` and
    ``bytes_accessed`` (``count_step``) and ``collectives``
    (``collectives_from_specs``) for one cell."""
    cell = build_cell(cfg, shape, mesh)
    flops, nbytes, out = count_step(cfg, shape)
    return {"memory": {
                "argument_bytes": sum(
                    shp.per_device_bytes(a, s, mesh)
                    for a, s in zip(cell["args"], cell["arg_specs"])),
                "output_bytes": shp.per_device_bytes(
                    out, _out_specs(cfg, shape, mesh, cell, out), mesh),
                "temp_bytes": None, "code_bytes": None},
            "flops": float(flops), "bytes_accessed": float(nbytes),
            "collectives": collectives_from_specs(
                cfg, shape, mesh, cell["args"][0], cell["arg_specs"][0])}


def extrapolate(cfg, probes: dict, lo: int, hi: int, group: int) -> dict:
    """Linear extrapolation of per-device cost to the full layer count:
    total(L) = cost(lo) + (cost(hi) - cost(lo)) * (L/g - lo) / (hi - lo)."""
    n_groups = cfg.n_layers // group
    f = (n_groups - lo) / (hi - lo)
    out = {}
    for key in ("flops", "bytes_accessed"):
        a = probes["probe_lo"][key]
        b = probes["probe_hi"][key]
        out[key] = a + (b - a) * f
    a = probes["probe_lo"]["collectives"]["total_bytes"]
    b = probes["probe_hi"]["collectives"]["total_bytes"]
    out["collective_bytes"] = a + (b - a) * f
    # per-op collective extrapolation
    ops = set(probes["probe_lo"]["collectives"]["bytes_by_op"]) \
        | set(probes["probe_hi"]["collectives"]["bytes_by_op"])
    out["collective_by_op"] = {
        op: probes["probe_lo"]["collectives"]["bytes_by_op"].get(op, 0)
        + (probes["probe_hi"]["collectives"]["bytes_by_op"].get(op, 0)
           - probes["probe_lo"]["collectives"]["bytes_by_op"].get(op, 0)) * f
        for op in sorted(ops)}
    return out


def cell_plan(cfg, shape, limit_bytes=None) -> dict:
    """What running the cell whole on one device needs, from its trees on
    the meta device (GB): the params; in train their gradients (param
    dtype) and the two AdamW moments (moment dtype); the decode cache;
    and the activations' peak, estimated as the largest of the step's
    transients on top of what it keeps:

    * train (per microbatch of T = B / n x S tokens): the layer inputs the
      checkpoints keep (n_layers x T x d, compute dtype), one layer's
      recompute and backward (four f32 attention tiles [B / n, H, S,
      min(S, attn_chunk)], six [T, ff] compute-dtype and ten f32 [T, d]
      tensors), the CE chunk's logits (B / n x 512 x Vp, 14 bytes a
      logit: compute dtype, f32, its f32 gradient, the f32 input
      logsumexp keeps) and six f32 optimizer slices of 2^26;
    * prefill: the logits [B, S, Vp] in the compute dtype twice (the
      product and its return), four f32 attention tiles as above (the
      xLSTM: three f32 [B, H, c, c], c the mLSTM chunk or S) and four
      [B, S, max(d, ff)] f32 tensors;
    * decode: the f32 logits [B, Vp] three times; one layer's K cache
      up-cast to f32 twice (the up-cast and its copy laid out for the
      product) and three f32 score rows [B, H, S] (attention), or three
      f32 copies of one layer's state (the xLSTM's C, the mamba's h).

    ``fits`` compares the total with ``limit_bytes`` (``None``: no
    verdict)."""
    params = params_specs(cfg)
    gb = 1e9
    pb = tree_size_bytes(params)
    out = {"params_gb": pb / gb}
    b, s = shape.global_batch, shape.seq_len
    d, vp, cb = cfg.d_model, cfg.padded_vocab, cfg.cdtype.itemsize
    heads = max(cfg.n_heads, 1)
    ff = max(cfg.d_ff, cfg.expert_ff(), cfg.ssm_expand * d)
    keep = 0
    if shape.kind == "train":
        n = tree_param_count(params)
        keep = pb + 2 * n * moment_dtype(cfg.moment_dtype).itemsize
        out["grads_moments_gb"] = keep / gb
        keep += pb
        mb = b // max(cfg.microbatches, 1)
        t = mb * s
        act = (cfg.n_layers * t * d * cb
               + 4 * 4 * mb * heads * s * min(s, cfg.attn_chunk)
               + 6 * t * ff * cb + 10 * 4 * t * d
               + mb * min(s, 512) * vp * (cb + 12) + 6 * 4 * (1 << 26))
    elif shape.kind == "prefill":
        c = min(s, cfg.mlstm_chunk or s) if cfg.family == "ssm" else \
            min(s, cfg.attn_chunk)
        tile = 3 * 4 * b * heads * c * c if cfg.family == "ssm" else \
            4 * 4 * b * heads * s * c
        act = 2 * b * s * vp * cb + tile + 4 * 4 * b * s * max(d, ff)
    else:
        cache = cache_specs(cfg, shape)
        cache_b = tree_size_bytes(cache)
        out["cache_gb"] = cache_b / gb
        keep = cache_b
        layer = 0
        if "k" in cache:
            k = cache["k"]
            layer = 2 * 4 * k[0].numel() + 3 * 4 * b * heads * s
        for key in ("mlstm", "mamba_moe", "mamba_dense"):
            if key in cache:
                big = max(leaves(cache[key]), key=lambda t: t.numel())
                layer = max(layer, 3 * 4 * big[0, 0].numel())
        act = 3 * 4 * b * vp + layer
    out["activations_gb"] = act / gb
    out["need_gb"] = (pb + keep + act) / gb
    out["limit_gb"] = None if limit_bytes is None else limit_bytes / gb
    out["fits"] = None if limit_bytes is None else \
        pb + keep + act <= limit_bytes
    return out


def _card_limit(dev: torch.device):
    if dev.type != "cuda":
        return None
    return CARD_SHARE * torch.cuda.get_device_properties(dev).total_memory


def _seeded(cfg, shape, dev, seed: int = 0) -> tuple:
    """The step's inputs at the cell's own shape on ``dev``: params from
    ``init_params(seed)``; train and prefill batches of seeded tokens
    (labels the next tokens), frames and patch embeddings; a decode cache
    filled from a seeded generator up to ``seq_len - 1`` (every float leaf
    normal, the sLSTM normalisers 1 + |normal|; whisper's cross K/V from
    ``encode_prefill`` of seeded frames; ``len`` = seq_len - 1) and one
    seeded token a row."""
    api = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    params = api.init_params(seed, cfg, dev)
    b, s = shape.global_batch, shape.seq_len

    def tokens(*size):
        return torch.randint(0, cfg.vocab_size, size, generator=gen,
                             device=dev, dtype=torch.int32)

    def normal(*size):
        return torch.randn(size, generator=gen, device=dev).to(cfg.cdtype)

    if shape.kind != "decode":
        seq = tokens(b, s + 1)
        batch = {"tokens": seq[:, :-1].contiguous(),
                 "labels": seq[:, 1:].contiguous()}
        if cfg.family == "vlm":
            batch["patch_embeds"] = normal(b, cfg.n_patches, cfg.d_model)
            batch["positions"] = torch.arange(
                s, device=dev, dtype=torch.int32)[None, :, None].expand(
                b, s, 3).contiguous()
        if cfg.family == "encdec":
            batch["frames"] = normal(b, cfg.n_frames, cfg.d_model)
        return params, batch
    cache = api.init_cache(cfg, b, s, dev)
    for path, t in leaves_with_paths(cache):
        name = path.split("/")[-1]
        if name == "len":
            t.fill_(s - 1)
        elif t.is_floating_point() and name not in ("xk", "xv"):
            t.normal_(generator=gen)
            if name == "n" and path.startswith("slstm"):
                t.abs_().add_(1.0)
    if cfg.family == "encdec":
        with torch.inference_mode():
            cache = encdec.encode_prefill(
                params, cfg, normal(b, cfg.n_frames, cfg.d_model), cache)
    return params, cache, tokens(b)


def _rows(tree, b: int, n: int):
    """The first ``n`` batch rows of every leaf of a decode cache or batch
    (the batch dim: the first dim of size ``b``), copied to the CPU."""
    def take(t):
        if n < b:
            t = t.narrow(list(t.shape).index(b), 0, n)
        return t.to("cpu", copy=True)
    return tree_map(take, tree)


def _gap(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0


def _check(cfg, shape, step, cpu_args, card_out, rows: int) -> dict:
    """The card's step against the same step on CPU copies (the first
    ``rows`` batch rows of a prefill or decode; the whole step in train):
    each float output leaf within GAP_FACTOR x its gap between the CPU
    step in the cell's dtypes and the same step up-cast to f32, plus
    F32_FLOOR x its largest |value| (the card and the CPU sum in other
    orders, also in f32); integer leaves exactly, but the decode's token,
    which must be the argmax of the card's own logits (a near tie may
    fall either way between two summation orders)."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    args32 = tree_map(lambda t: t.to(torch.float32, copy=True)
                      if t.is_floating_point() else t.clone(), cpu_args)
    want = step(*cpu_args)
    want32 = _make_step(cfg32, shape)(*args32)
    got = _rows(card_out, shape.global_batch, rows) \
        if shape.kind != "train" else tree_map(
            lambda t: t.to("cpu", copy=True), card_out)
    worst = 0.0
    for (path, g), (_, w), (_, w32) in zip(leaves_with_paths(got),
                                           leaves_with_paths(want),
                                           leaves_with_paths(want32)):
        if shape.kind == "decode" and path == "0":
            if not torch.equal(g, got[1].argmax(-1).to(g.dtype)):
                raise AssertionError("the card's decode token is not the "
                                     "argmax of its logits")
            continue
        if not g.is_floating_point():
            if not torch.equal(g, w):
                raise AssertionError(f"{path}: the card's integers differ "
                                     f"from the CPU's")
            continue
        err, gap = _gap(g, w), _gap(w, w32)
        top = float(w.float().abs().max()) if w.numel() else 0.0
        bound = GAP_FACTOR * gap + F32_FLOOR * max(top, 1.0)
        if not err <= bound:
            raise AssertionError(f"{path}: card vs CPU {err:.4g} > bound "
                                 f"{bound:.4g} (f32 gap {gap:.4g})")
        worst = max(worst, err / bound)
    return {"rows": rows if shape.kind != "train" else None,
            "worst_share_of_bound": worst}


def _make_step(cfg, shape):
    if shape.kind == "decode":
        return make_decode_step(cfg)
    if shape.kind == "prefill":
        return make_prefill_step(cfg)
    return make_train_step(cfg, opt_config(cfg))


def run_whole(cfg, shape, dev, runs: int = 5, check: bool = False) -> dict:
    """The cell's step at its own shape on ``dev``: inputs built
    (``_seeded``), one call (``first_call_s``), with ``check`` that call
    held against CPU copies (``_check``), one more between a reset of the
    peak and its read (``temp_bytes``, ``peak_bytes``), then ``runs``
    calls timed by CUDA events (the host clock on the CPU). A decode step
    writes the same cache slot each time; a train step updates the params
    and moments in place, each step the next."""
    _sync(dev)
    t0 = time.perf_counter()
    args = _seeded(cfg, shape, dev)
    if shape.kind == "train":
        args = (args[0], adamw_init(args[0], opt_config(cfg)), args[1])
    _sync(dev)
    rec = {"build_s": round(time.perf_counter() - t0, 3)}
    step = _make_step(cfg, shape)
    rows = min(CHECK_ROWS, shape.global_batch)
    cpu_args = None
    if check:
        if shape.kind == "train":
            cpu_args = tree_map(lambda t: t.to("cpu", copy=True), args)
        else:
            cpu_args = (tree_map(lambda t: t.to("cpu", copy=True), args[0]),
                        *(_rows(a, shape.global_batch, rows)
                          for a in args[1:]))
    t0 = time.perf_counter()
    out = step(*args)
    _sync(dev)
    rec["first_call_s"] = round(time.perf_counter() - t0, 3)
    if check:
        rec["check"] = _check(cfg, shape, step, cpu_args, out, rows)
        del cpu_args
    del out
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step(*args)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    times = [_timed_ms(lambda: step(*args), dev) for _ in range(runs)]
    rec.update(step_ms=statistics.median(times) if times else None,
               runs=runs, temp_bytes=max(peak - base, 0), peak_bytes=peak)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             probes: bool = True, out_dir: str = "results/dryrun",
             verbose: bool = True, probes_only: bool = False, cfg=None,
             device=None, whole: bool = False, runs: int = 5,
             check: bool = False,
             memo: dict | None = None) -> dict:
    """One (arch x shape x mesh) cell: sized on the meta device (module
    docstring) and, where its plan or ``whole`` says so, run whole on
    ``device``; the record written to ``out_dir`` and returned. ``cfg`` replaces
    ``get_config(arch)`` (a test's ``reduced_config``). The cell runs
    whole on the card when its ``cell_plan`` fits ``CARD_SHARE`` of the
    card's memory, and never on the CPU; ``whole`` runs it on ``device``
    whatever the plan (a reduced cell on the CPU). ``probes`` adds
    the 1- and 2-group probes and ``corrected``; ``probes_only`` merges
    them into the record already in ``out_dir`` (computing it first where
    there is none). ``memo`` (a dict) keeps a card run for the other
    mesh's record of the same cell: one card runs the whole unsharded
    step, whatever the mesh."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind}
    if not ok:
        rec["skipped"] = why
        _write(out_dir, rec)
        return rec
    path = os.path.join(out_dir, f"{arch}_{shape_name}_{mesh_name}.json")
    if probes_only and os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if "corrected" in rec:
            print(f"[dryrun] {arch}_{shape_name}: probes already done")
            return rec
    else:
        probes_only = False
    dev = resolve(device)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    rec["devices"] = mesh.size
    if not probes_only:
        t0 = time.perf_counter()
        rec["main"] = analyze(cfg, shape, mesh)
        rec["count_s"] = round(time.perf_counter() - t0, 3)
        plan = cell_plan(cfg, shape, _card_limit(dev))
        rec["plan"] = plan
        if whole or plan["fits"] is True:
            key = (cfg, shape_name, str(dev), runs, check)
            card = (memo or {}).get(key) or run_whole(cfg, shape, dev, runs,
                                                      check)
            if memo is not None:
                memo[key] = card
            rec["ran"] = "card" if dev.type == "cuda" else dev.type
            rec["device"] = _card_line() if dev.type == "cuda" else "cpu"
            for name in ("temp_bytes", "peak_bytes"):
                rec["main"]["memory"][name] = card[name]
            rec.update({k: v for k, v in card.items()
                        if k not in ("temp_bytes", "peak_bytes")})
        else:
            rec["ran"] = "meta"
            rec["why_meta"] = (f"device {dev.type}" if plan["fits"] is None
                               else f"plan {plan['need_gb']:.2f} GB > "
                                    f"{plan['limit_gb']:.2f} GB")
    if probes or probes_only:
        g = _group_size(cfg)
        lo, hi = PROBE_STACKS[cfg.family]
        probe_res = {}
        for tag, n in (("probe_lo", lo), ("probe_hi", hi)):
            pcfg = _probe_cfg(cfg, n)
            t0 = time.perf_counter()
            probe_res[tag] = analyze(pcfg, shape, mesh)
            probe_res[tag]["layers"] = pcfg.n_layers
            probe_res[tag]["count_s"] = round(time.perf_counter() - t0, 3)
        rec["probes"] = probe_res
        rec["corrected"] = extrapolate(cfg, probe_res, lo, hi, g)
    _write(out_dir, rec, verbose)
    return rec


def _write(out_dir: str, rec: dict, verbose: bool = True) -> None:
    """The record as ``<arch>_<shape>_<mesh>.json`` (a GUS cell's as
    ``<kind>_<mesh>.json``), the reference's names, and one line."""
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}"
    if rec.get("kind", "").startswith("gus_"):
        name = f"{rec['kind']}_{rec['mesh']}"
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    if not verbose:
        return
    if "skipped" in rec or "error" in rec:
        print(f"[dryrun] {name}: {'SKIP' if 'skipped' in rec else 'ERROR'}")
        return
    mem = rec["main"]["memory"]
    if name.startswith("gus_"):
        print(f"[dryrun] {name}: OK (build {rec['build_s']} s, first call "
              f"{rec['first_call_s']} s, step {rec['step_ms']} ms, "
              f"temp_bytes {mem['temp_bytes']}, peak "
              f"{mem['peak_bytes'] / 1e9:.3f} GB, {rec['device']})")
        return
    main, plan = rec["main"], rec["plan"]
    line = (f"[dryrun] {name}: OK (ran {rec['ran']}, count {rec['count_s']} "
            f"s, flops {main['flops']:.4g}, bytes "
            f"{main['bytes_accessed']:.4g}, plan {plan['need_gb']:.2f} GB")
    if rec["ran"] != "meta":
        line += (f", step {rec['step_ms']} ms, peak "
                 f"{mem['peak_bytes'] / 1e9:.3f} GB, {rec['device']}")
    print(line + ")")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
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
    ap.add_argument("--reduced", action="store_true",
                    help="the arch cells at reduced_config (tests)")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--probes-only", action="store_true",
                    help="add probe corrections to existing records")
    ap.add_argument("--device", default=None,
                    help="the device of every shard, or of an arch cell "
                         "run whole (default: the card)")
    ap.add_argument("--runs", type=int, default=5,
                    help="timed steps after the first")
    ap.add_argument("--check", action="store_true",
                    help="check each step's answer (module docstring)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more GUS step on the card")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multipod]
    if args.gus or args.gus_mutate or args.gus_delete:
        op = ("mutate" if args.gus_mutate
              else "delete" if args.gus_delete else "query")
        for mp in meshes:
            run_gus_cell(mp, args.out, op=op, merge=args.gus_merge,
                         n_partitions=args.gus_partitions,
                         slab=args.gus_slab, tag=args.gus_tag,
                         shards=args.gus_shards, device=args.device,
                         runs=args.runs, check=args.check,
                         profile=args.profile)
        return
    archs = list(ARCHS) if args.arch in (None, "all") else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    sweep(archs, shapes, meshes, out_dir=args.out, reduced=args.reduced,
          probes=not args.no_probes, probes_only=args.probes_only,
          device=args.device, runs=args.runs, check=args.check)


def sweep(archs, shapes, meshes, out_dir: str = "results/dryrun",
          reduced: bool = False, **cell) -> list:
    """``run_cell`` over every shape, arch and mesh, shape-major (all the
    train cells first; ``reduced``: each arch at its ``reduced_config``);
    a cell that raises is written as an ``error`` record and the sweep
    goes on. Returns the records."""
    memo, recs = {}, []
    for shape in shapes:
        for arch in archs:
            for mp in meshes:
                try:
                    cfg = reduced_config(arch) if reduced else None
                    recs.append(run_cell(arch, shape, mp, out_dir=out_dir,
                                         cfg=cfg, memo=memo, **cell))
                except Exception as e:  # keep sweeping; record the failure
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "kind": SHAPES[shape].kind,
                           "error": f"{type(e).__name__}: {e}"[:500]}
                    _write(out_dir, rec)
                    recs.append(rec)
    return recs

if __name__ == "__main__":
    sys.exit(main())
