"""The dry-run's GUS cells of the port against the reference, on the CPU.

The reference's ``repro/launch/dryrun.py`` sets ``XLA_FLAGS`` (512 host
devices) when it is imported, so it runs once, in a module-scoped
subprocess, as ``tests/test_sharded.py`` runs its meshes. There:

* ``run_gus_cell(shards=2)`` for each op and merge: its records (``arch``,
  ``shape``, ``mesh``, ``kind``, the file name) and the shrunk cell each
  step factory was given;
* ``index_specs``, ``index_shapes`` and the ``*_shapes`` of the default
  cell;
* the jitted query (flat and hier), mutate and delete steps on the state
  the port's ``seeded_cell`` draws at the shrunk cell of two shards
  (K = 16, d = 128, M = 16; handed over as numpy), on ``make_gus_mesh(2)``,
  ``make_test_mesh((2, 2))`` and a 3-axis ``(2, 2, 2)`` mesh over ("pod",
  "data", "model"). The values are small integers, so every sum is exact
  and the port's steps equal the reference's bit for bit (distances by
  their bits, rows exactly, slabs, routes and cursors exactly).

In this process the port runs the same cells on the CPU: its records,
its steps on every shard's state, the collective counts against the
bytes the steps' gathers hold, the cells' checks (and that they catch a
wrong answer), and ``--arch`` exiting non-zero.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ann import sharded as T
from repro_torch.kernels import _build
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (GusMesh, dp_axes, make_gus_mesh,
                                     make_production_mesh, make_test_mesh,
                                     model_axis)

ROOT = Path(__file__).resolve().parent.parent
OPS = [(op, merge) for op in ("query", "mutate", "delete")
       for merge in ("flat", "hier")]
MESHES = {"cpu2": ((2,), ("data",)), "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# the reference's dtypes -> the port's: uint32 values are int64 but for the
# row ids (int32 bits), and the tombstones are int64 (the mutate step's
# routes)
DTYPES = {"float32": torch.float32, "uint32": torch.int64,
          "uint8": torch.uint8, "bool": torch.bool, "int32": torch.int32}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_cell():
    """The shrunk cell of two shards, its mesh and seeded state."""
    cell = dryrun.gus_cell(shards=2)
    mesh = make_gus_mesh(2, device="cpu")
    states, inputs = T.seeded_cell(cell, mesh, seed=0)
    return cell, states, inputs


def _global(states: list) -> dict:
    """The shards' state as the reference's global numpy arrays."""
    out = {key: T.global_array(states, key).numpy()
           for key in T.STATE_KEYS if key != "books"}
    out["books"] = states[0]["books"].numpy()
    for key in ("members_idx", "row_ids"):
        out[key] = out[key].astype(np.uint32)
    return out


def _split(arrays: dict, mesh) -> list:
    """Global arrays -> one state per shard of ``mesh`` (copies)."""
    n = mesh.size
    states = []
    for i in range(n):
        st = {}
        for key, a in arrays.items():
            t = torch.as_tensor(np.array(a))
            if key != "books":
                t = t[i * (len(t) // n):(i + 1) * (len(t) // n)]
            st[key] = (T.ops._as_int32_bits(t) if key == "row_ids"
                       else t.to(torch.int64) if key == "members_idx"
                       else t).clone()
        states.append(st)
    return states


def _mesh(name: str) -> GusMesh:
    return make_test_mesh(*MESHES[name], device="cpu")


_REFERENCE = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np
    import repro.launch.dryrun as D     # sets XLA_FLAGS before jax starts
    import jax, jax.numpy as jnp
    from repro.ann import sharded as J
    from repro.launch.mesh import make_gus_mesh, make_test_mesh, mesh_context

    out_dir, in_path, out_path = sys.argv[1:4]
    meshes = json.loads(sys.argv[4])
    meta = {"records": {}}
    captured = {}
    for name in ("make_query_step", "make_mutate_step", "make_delete_step"):
        def wrap(mesh, cell, *a, _orig=getattr(J, name), **kw):
            captured["cell"] = dataclasses.asdict(cell)
            return _orig(mesh, cell, *a, **kw)
        setattr(J, name, wrap)
    for op in ("query", "mutate", "delete"):
        for merge in ("flat", "hier"):
            seen = set(os.listdir(out_dir))
            rec = D.run_gus_cell(False, out_dir, op=op, merge=merge, shards=2)
            meta["records"][f"{op}_{merge}"] = dict(
                {k: rec[k] for k in ("arch", "shape", "mesh", "kind")},
                files=sorted(set(os.listdir(out_dir)) - seen),
                cell=captured["cell"])
    cell = J.GusCellConfig()
    def sds(s):
        return [list(s.shape), str(s.dtype)]
    meta["index_shapes"] = {k: sds(v) for k, v in J.index_shapes(cell).items()}
    for name in ("query", "mutate", "delete"):
        meta[f"{name}_shapes"] = [sds(v) for v in
                                  getattr(J, f"{name}_shapes")(cell)]

    inp = dict(np.load(in_path))
    STATE = ("centroids", "books", "members_idx", "members_val", "codes",
             "row_ids", "valid", "counts")
    small = J.GusCellConfig(**json.loads(sys.argv[5]))
    out, meta["specs"] = {}, {}
    for tag, (shape, axes) in meshes.items():
        mesh = make_test_mesh(tuple(shape), tuple(axes))
        def split(v):    # dim 0 over every axis (one axis may be bare)
            first = v[0] if isinstance(v[0], tuple) else (v[0],)
            return (0 if first == tuple(axes) and all(
                e is None for e in tuple(v)[1:]) else str(v))
        meta["specs"][tag] = {
            k: None if len(v) == 0 else split(v)
            for k, v in J.index_specs(small, mesh).items()}
        state = {k: jnp.asarray(inp[k]) for k in STATE}
        with mesh_context(mesh):
            for merge in ("flat", "hier"):
                rows, dists = jax.jit(J.make_query_step(
                    mesh, dataclasses.replace(small, merge=merge)))(
                    jnp.asarray(inp["q_idx"]), jnp.asarray(inp["q_val"]),
                    jnp.asarray(inp["q_sk"]), state)
                out[f"{tag}_{merge}_rows"] = rows
                out[f"{tag}_{merge}_dists"] = dists
            st, (rp, rpos) = jax.jit(J.make_mutate_step(mesh, small))(
                *(jnp.asarray(inp[k]) for k in
                  ("ids", "new_idx", "new_val", "new_sk", "new_codes")),
                state)
            st2 = jax.jit(J.make_delete_step(mesh, small))(
                rp.reshape(-1), rpos.reshape(-1), st)
        out[f"{tag}_route_part"], out[f"{tag}_route_pos"] = rp, rpos
        for k in ("members_idx", "members_val", "codes", "row_ids", "valid",
                  "counts"):
            out[f"{tag}_mut_{k}"] = st[k]
        out[f"{tag}_del_valid"] = st2["valid"]
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    print(json.dumps(meta))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's records, shapes and steps, once per module, in one
    subprocess; the port's seeded state goes in as numpy."""
    cell, states, inputs = _port_cell()
    arrays = _global(states)
    q_idx, q_val, q_sk = (t.numpy() for t in inputs["query"])
    ids, new_idx, new_val, new_sk, new_codes = (t.numpy()
                                                for t in inputs["mutate"])
    tmp = tmp_path_factory.mktemp("dryrun_ref")
    (tmp / "records").mkdir()
    np.savez(tmp / "in.npz", **arrays, q_idx=q_idx.astype(np.uint32),
             q_val=q_val, q_sk=q_sk, ids=ids.astype(np.uint32),
             new_idx=new_idx.astype(np.uint32), new_val=new_val,
             new_sk=new_sk, new_codes=new_codes)
    small = {f.name: getattr(cell, f.name) for f in dataclasses.fields(cell)}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "records"),
         str(tmp / "in.npz"), str(tmp / "out.npz"), json.dumps(MESHES),
         json.dumps(small)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    meta = json.loads(out.stdout.strip().splitlines()[-1])
    return meta, dict(np.load(tmp / "out.npz")), arrays, inputs, cell


@pytest.mark.parametrize("op,merge", OPS)
def test_records_and_shrunk_cells_match_reference(reference, tmp_path, op,
                                                  merge):
    """``run_gus_cell(shards=2)`` on the CPU: the record's arch, shape,
    mesh and kind, the file it writes and the shrunk cell equal the
    reference's; the memory, cost and collective fields are filled."""
    want = reference[0]["records"][f"{op}_{merge}"]
    rec = dryrun.run_gus_cell(False, str(tmp_path), op=op, merge=merge,
                              shards=2, device="cpu", runs=1)
    assert {k: rec[k] for k in ("arch", "shape", "mesh", "kind")} == {
        k: want[k] for k in ("arch", "shape", "mesh", "kind")}
    assert sorted(os.listdir(tmp_path)) == want["files"]
    assert dataclasses.asdict(dryrun.gus_cell(merge=merge, shards=2)) \
        == want["cell"]
    with open(tmp_path / want["files"][0]) as f:
        assert json.load(f) == rec
    main = rec["main"]
    assert main["memory"]["argument_bytes"] > 0
    assert main["bytes_accessed"] > 0 and rec["step_ms"] > 0
    assert set(main["collectives"]) == {"total_bytes", "bytes_by_op",
                                        "count_by_op"}
    assert rec["device"] == "cpu" and rec["build_s"] >= 0


def test_shapes_and_specs_match_reference(reference):
    """``index_shapes`` and the ``*_shapes`` give the reference's shapes,
    with its dtypes mapped as ``DTYPES`` says; ``index_specs`` splits dim
    0 over every mesh axis where the reference does, and replicates what
    it replicates."""
    meta = reference[0]
    cell = T.GusCellConfig()

    def port(shape, dtype, key=""):
        want = (torch.int32 if key == "row_ids" else torch.int64
                if key == "delete" else DTYPES[dtype])
        return list(shape), want

    got = T.index_shapes(cell)
    assert set(got) == set(meta["index_shapes"])
    for key, (shape, dtype) in meta["index_shapes"].items():
        assert (list(got[key][0]), got[key][1]) == port(shape, dtype, key)
    for name in ("query", "mutate", "delete"):
        got = getattr(T, f"{name}_shapes")(cell)
        assert [(list(s), d) for s, d in got] == [
            port(s, d, "delete" if name == "delete" else "")
            for s, d in meta[f"{name}_shapes"]]
    for tag in MESHES:
        assert T.index_specs(cell, _mesh(tag)) == meta["specs"][tag]


@pytest.mark.parametrize("tag", list(MESHES))
def test_steps_match_reference(reference, tag):
    """On the port's seeded state at the shrunk cell (K = 16, d = 128,
    M = 16): the query step, flat and hier, the mutate step's routes and
    slabs, and the delete step on the sites it reported, equal the
    reference's bit for bit on each mesh."""
    _, out, arrays, inputs, cell = reference
    mesh = _mesh(tag)
    assert mesh.shape == MESHES[tag][0]
    for merge in ("flat", "hier"):
        rows, dists = T.make_query_step(
            mesh, dataclasses.replace(cell, merge=merge))(
            *inputs["query"], _split(arrays, mesh))
        want_d = out[f"{tag}_{merge}_dists"]
        assert np.array_equal(dists.numpy().view(np.int32),
                              want_d.view(np.int32))
        fin = np.isfinite(want_d)
        assert fin.all()
        np.testing.assert_array_equal(rows.numpy(),
                                      out[f"{tag}_{merge}_rows"])
    states = _split(arrays, mesh)
    states, (part, pos) = T.make_mutate_step(mesh, cell)(*inputs["mutate"],
                                                         states)
    np.testing.assert_array_equal(part.numpy(), out[f"{tag}_route_part"])
    np.testing.assert_array_equal(pos.numpy(), out[f"{tag}_route_pos"])
    assert (part >= 0).all()
    for key in T.MUTABLE:
        got = T.global_array(states, key).numpy()
        np.testing.assert_array_equal(
            got, out[f"{tag}_mut_{key}"].astype(got.dtype), err_msg=key)
    states = T.make_delete_step(mesh, cell)(part.reshape(-1),
                                            pos.reshape(-1), states)
    np.testing.assert_array_equal(T.global_array(states, "valid").numpy(),
                                  out[f"{tag}_del_valid"])


def _operand_bytes(parts) -> int:
    return sum(t.numel() * t.element_size() for t in parts)


def test_collectives_count_the_gathers(reference, monkeypatch):
    """``dryrun.collectives`` holds the bytes the steps' gathers and sums
    hold: flat, every shard's top-k scores (f32) and rows (int64) that
    the merge concatenates; hier, those within each "data" row, then each
    row's top-k; mutate, every shard's routes (two int64 sums); delete,
    none. The step's ``torch.cat`` and ``sum`` calls are read as they
    run."""
    _, _, arrays, inputs, cell = reference
    mesh = _mesh("2x2x2")
    held = []
    cat = torch.cat

    def spy_cat(parts, *args, **kwargs):
        held.append(_operand_bytes(parts))
        return cat(parts, *args, **kwargs)

    def spy_sum(parts):
        parts = list(parts)
        held.append(_operand_bytes(parts))
        return sum(parts)

    for merge, gathers in (("flat", 2), ("hier", 4)):
        mcell = dataclasses.replace(cell, merge=merge)
        states = _split(arrays, mesh)
        held.clear()
        with monkeypatch.context() as m:
            m.setattr(torch, "cat", spy_cat)
            T.make_query_step(mesh, mcell)(*inputs["query"], states)
        got = dryrun.collectives("query", mcell, mesh)
        assert held and got == {
            "total_bytes": sum(held), "bytes_by_op": {"all-gather": sum(held)},
            "count_by_op": {"all-gather": gathers}}
    states = _split(arrays, mesh)
    held.clear()
    with monkeypatch.context() as m:
        m.setattr(T, "sum", spy_sum, raising=False)
        T.make_mutate_step(mesh, cell)(*inputs["mutate"], states)
    assert len(held) == 2 and dryrun.collectives("mutate", cell, mesh) == {
        "total_bytes": sum(held), "bytes_by_op": {"all-reduce": sum(held)},
        "count_by_op": {"all-reduce": 2}}
    assert dryrun.collectives("delete", cell, mesh)["total_bytes"] == 0


@pytest.mark.parametrize("op", ["query", "mutate", "delete"])
def test_cell_checks_pass_and_catch_a_wrong_answer(tmp_path, op):
    """``run_gus_cell(check=True)`` passes at the shrunk cell on a
    four shards; each check raises on an answer with one
    entry wrong."""
    rec = dryrun.run_gus_cell(False, str(tmp_path), op=op, shards=4,
                              device="cpu", runs=0, check=True)
    assert rec["check"] and rec["step_ms"] is None
    cell, states, inputs = _port_cell()
    mesh = make_gus_mesh(2, device="cpu")
    if op == "query":
        rows, dists = T.make_query_step(mesh, cell)(*inputs["query"], states)
        dists[3, 7] += 1
        with pytest.raises(AssertionError, match="differ"):
            dryrun.check_query(mesh, cell, states, inputs["query"],
                               (rows, dists))
        return
    before = [{key: st[key].clone() for key in T.MUTABLE} for st in states]
    states, routes = T.make_mutate_step(mesh, cell)(*inputs["mutate"],
                                                    states)
    if op == "mutate":
        states[1]["codes"][0, 1000, 3] ^= 1      # a slot nobody wrote
        with pytest.raises(AssertionError, match="outside"):
            dryrun.check_mutate(mesh, cell, before, states, inputs["mutate"],
                                routes)
        return
    parts, poss = (r.reshape(-1) for r in routes)
    valid = [st["valid"].clone() for st in states]
    states = T.make_delete_step(mesh, cell)(parts, poss, states)
    states[0]["valid"][0, 0] = False             # one more bit cleared
    with pytest.raises(AssertionError, match="differ"):
        dryrun.check_delete(mesh, cell, valid, states, parts, poss)


def test_meshes_and_cli(tmp_path, capsys):
    """The production meshes' shapes and axes, the axis helpers, a CLI run
    at two shards on the CPU, and ``--arch`` / no cell exiting non-zero
    with the roadmap item named."""
    mesh = make_production_mesh(device="cpu")
    assert (mesh.shape, mesh.axis_names, mesh.size) == (
        (16, 16), ("data", "model"), 256)
    pod = make_production_mesh(multi_pod=True, device="cpu")
    assert (pod.shape, pod.axis_names, pod.size) == (
        (2, 16, 16), ("pod", "data", "model"), 512)
    assert dp_axes(pod) == ("pod", "data") and model_axis(pod) == "model"
    assert dp_axes(mesh) == ("data",)
    assert make_test_mesh(device="cpu").shape == (2, 4)
    dryrun.main(["--gus-delete", "--gus-shards", "2", "--device", "cpu",
                 "--runs", "1", "--out", str(tmp_path)])
    assert os.listdir(tmp_path) == ["gus_delete_cpu2.json"]
    assert "[dryrun] gus_delete_cpu2: OK" in capsys.readouterr().out
    for argv in (["--arch", "dense"], ["--shape", "train"], []):
        with pytest.raises(SystemExit) as exit_:
            dryrun.main(argv)
        assert exit_.value.code != 0
        assert "ROADMAP.md Queue 1 item 5" in capsys.readouterr().err


def test_kernel_sizes_past_int32_are_refused():
    """The two kernels of the step take their sizes as ``int``: the
    production cell's fit (B * N * M = 2^30 is addressed in size_t, the
    per-shard sizes here in int), and a size past int32 is refused with
    an error instead of wrapping."""
    cell = T.GusCellConfig()
    n = cell.nprobe_local * cell.slab
    _build.check_int32("fused_query", N=n,
                       blocks=cell.query_batch * -(-n // 4096))
    _build.check_int32("sparse_rescore_topk", B=cell.query_batch, N=n,
                       slab_rows=cell.n_partitions // 256 * cell.slab)
    with pytest.raises(ValueError, match="int32"):
        _build.check_int32("fused_query", N=n, blocks=2 ** 31)
