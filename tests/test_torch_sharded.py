"""The sharded backend of the port against the reference, on the CPU.

* Step level, one shard, in this process: the port's four programs
  (``repro_torch.ann.sharded``) against the reference's ``make_*_step`` on
  a one-device mesh, at ``tests/test_sharded.py``'s sizes (C=16, S=32,
  K=4, d_proj=16, M=4, nprobe_local=2, top_k=5), on a random state whose
  values are small integers: every sum is then exact in any order, so the
  comparisons are bitwise (distances by their bits, ids exactly), ties
  and their order included.
* Several shards, against the reference run once in a subprocess with
  four forced host devices (``XLA_FLAGS``, as ``tests/test_sharded.py``
  does): the step programs at 2 and 4 shards and the ``"hier"`` merge on
  a 2x2 grid (bitwise, as above), and an index-level stream at 4 shards
  (the reference's trained centroids and codebooks carried across with
  ``ShardedGusIndex.from_trained``): placements and ``occupancy()``
  equal field for field after every stage, search answers equal (ids
  exactly, distances within rtol 1e-6 / atol 1e-6: float sums in another
  order). The port runs every shard on the CPU in this process.
* The engine at one shard against the reference's
  (``tests/test_gus_engine.py:171``), and the port's own lifecycle at 1-4
  shards (``tests/test_sharded_lifecycle.py``,
  ``tests/test_backend_protocol.py``, ``tests/test_dynamic_equivalence.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import sharded as J
from repro.launch.mesh import make_gus_mesh as j_gus_mesh
from repro.launch.mesh import mesh_context
from repro_torch.ann import sharded as T
from repro_torch.ann.brute import BruteIndex
from repro_torch.ann.sharded_index import ShardedConfig, ShardedGusIndex
from repro_torch.core import BucketConfig
from repro_torch.core import hashing
from repro_torch.core.embedding import EmbeddingGenerator
from repro_torch.core.maintenance import MaintenanceConfig
from repro_torch.core.types import SparseBatch
from repro_torch.data.synthetic import OGB_ARXIV_LIKE, make_dataset
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_gus_mesh, make_pod_meshes

ROOT = Path(__file__).resolve().parent.parent
CELL = dict(n_rows=16 * 32, k_dims=4, d_proj=16, pq_m=4, n_partitions=16,
            slab=32, nprobe_local=2, query_batch=8, top_k=5, mutate_batch=64)
ARRAYS = ("members_idx", "members_val", "codes", "row_ids", "valid", "counts")
BASE = dict(n_shards=1, d_proj=32, n_partitions=8, nprobe_local=0,
            reorder=8192, pq_m=4, kmeans_iters=4, pq_iters=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# the random state and batches of the step cases, from a numpy seed; the
# subprocess below runs the same function (its source is pasted in)
def _step_inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    c, s, k, d, m = 16, 32, 4, 16, 4
    ints = np.asarray([-3, -2, -1, 1, 2, 3], np.float32)
    out = {
        "centroids": rng.integers(-4, 5, (c, d)).astype(np.float32),
        "books": rng.integers(-3, 4, (m, 256, d // m)).astype(np.float32),
        "members_idx": np.where(rng.random((c, s, k)) < 0.2, 0xFFFFFFFF,
                                rng.integers(0, 30, (c, s, k))
                                ).astype(np.uint32),
        "members_val": rng.choice(ints, (c, s, k)),
        "codes": rng.integers(0, 256, (c, s, m)).astype(np.uint8),
        # ids from a small range: SOAR-like duplicates across slots
        "row_ids": rng.integers(0, 200, (c, s)).astype(np.uint32),
        "valid": rng.random((c, s)) < 0.8,
        # cursors anywhere in the ring: appends wrap modulo S
        "counts": rng.integers(0, s, (c,)).astype(np.int32),
        "q_idx": rng.integers(0, 30, (8, k)).astype(np.uint32),
        "q_val": rng.choice(ints, (8, k)),
        "q_sk": rng.integers(-3, 4, (8, d)).astype(np.float32),
    }
    ids = np.full((64,), 0xFFFFFFFF, np.uint32)
    ids[:48] = rng.choice(np.arange(1000, 5000), 48, replace=False)
    out.update(
        ids=ids, new_idx=rng.integers(0, 30, (64, k)).astype(np.uint32),
        new_val=rng.choice(ints, (64, k)),
        new_sk=rng.integers(-6, 7, (64, d)).astype(np.float32),
        new_codes=rng.integers(0, 256, (64, m)).astype(np.uint8),
        new_codes2=rng.integers(0, 256, (64, m)).astype(np.uint8))
    # tombstones: padding pairs (-1), pairs past the last partition and
    # real slots
    parts = rng.integers(-1, c + 4, (64,)).astype(np.int32)
    out.update(del_parts=parts,
               del_poss=rng.integers(0, s, (64,)).astype(np.int32))
    # a nearly empty index: one live slot in each partition of the first
    # two of four shards, so a query's two probes a shard find four live
    # rows, fewer than top_k
    out["valid_sparse"] = np.zeros((c, s), bool)
    out["valid_sparse"][:c // 2, 0] = True
    return out


STATE_KEYS = ("centroids", "books", "members_idx", "members_val", "codes",
              "row_ids", "valid", "counts")


def _state(inp: dict) -> dict:
    return {k: inp[k] for k in STATE_KEYS}


def _shard_arrays(arrays: dict, mesh) -> list[dict]:
    """Global index arrays (the reference's layout: ``[C, ...]``, books
    replicated, row ids uint32 in any integer dtype) -> one dict per shard
    on its device, partitions split in linear order (copies: the steps
    write them in place)."""
    n = mesh.size
    out = []
    for i, dev in enumerate(mesh.devices):
        st = {}
        for key, a in arrays.items():
            a = torch.tensor(np.asarray(a))
            if key == "books":
                st[key] = a.to(dev)
                continue
            part = a[i * (a.shape[0] // n):(i + 1) * (a.shape[0] // n)]
            if key == "row_ids":
                part = ops._as_int32_bits(part)
            elif key == "members_idx":
                part = part.to(torch.int64)
            st[key] = part.to(dev)
        out.append(st)
    return out


def _port_query(inp, mesh, cell):
    step = T.make_query_step(mesh, T.GusCellConfig(**cell))
    rows, dists = step(torch.as_tensor(inp["q_idx"].astype(np.int64)),
                       torch.as_tensor(inp["q_val"]),
                       torch.as_tensor(inp["q_sk"]),
                       _shard_arrays(_state(inp), mesh))
    return rows.numpy(), dists.numpy()


def _port_mutate(inp, mesh, cell, salt):
    step = T.make_mutate_step(mesh, T.GusCellConfig(**cell), salt)
    states, (r_part, r_pos) = step(
        torch.as_tensor(inp["ids"].astype(np.int64)),
        torch.as_tensor(inp["new_idx"].astype(np.int64)),
        torch.as_tensor(inp["new_val"]), torch.as_tensor(inp["new_sk"]),
        torch.as_tensor(inp["new_codes"]), _shard_arrays(_state(inp), mesh),
        new_codes2=torch.as_tensor(inp["new_codes2"]))
    return states, r_part.numpy(), r_pos.numpy()


def _assert_query_equal(want_rows, want_d, rows, dists):
    """Distances bit for bit; ids exactly where the distance is finite,
    and -1 where it is not (the reference globalises the rows of -inf
    scores too: both are padding to the host)."""
    assert np.array_equal(dists.view(np.int32), want_d.view(np.int32))
    fin = np.isfinite(want_d)
    np.testing.assert_array_equal(np.where(fin, want_rows, -1), rows)
    return fin


def _assert_states_equal(want: dict, states: list):
    for key in ARRAYS:
        got = T.global_array(states, key).numpy()
        np.testing.assert_array_equal(got, np.asarray(want[key]).astype(
            got.dtype), err_msg=key)


# ------------------------------------------------ step level, one shard

@pytest.fixture(scope="module")
def one_shard():
    return _step_inputs(0), j_gus_mesh(1), make_gus_mesh(1, device="cpu")


@pytest.mark.parametrize("fused,int8", [(True, False), (False, False),
                                        (True, True), (False, True)])
def test_query_step_matches_reference(one_shard, fused, int8):
    """Ids exactly and distances bitwise, both shortlist forms and the
    int8 table, at integer values (exact sums, many ties)."""
    inp, jm, tm = one_shard
    cell = dict(CELL, fused=fused, pq_int8=int8)
    with mesh_context(jm):
        rows, dists = jax.jit(J.make_query_step(jm, J.GusCellConfig(**cell)))(
            jnp.asarray(inp["q_idx"]), jnp.asarray(inp["q_val"]),
            jnp.asarray(inp["q_sk"]),
            {k: jnp.asarray(v) for k, v in _state(inp).items()})
    fin = _assert_query_equal(np.asarray(rows), np.asarray(dists),
                              *_port_query(inp, tm, cell))
    assert fin.mean() > 0.5


@pytest.mark.parametrize("soar", [1.0, -1.0])
def test_mutate_step_matches_reference(one_shard, soar):
    """Routes, slabs and cursors bitwise, with and without the SOAR copy;
    padding rows (PAD_ID) land nowhere."""
    inp, jm, tm = one_shard
    cell = dict(CELL, soar_lambda=soar)
    with mesh_context(jm):
        st, (r_part, r_pos) = jax.jit(J.make_mutate_step(
            jm, J.GusCellConfig(**cell), 5))(
            jnp.asarray(inp["ids"]), jnp.asarray(inp["new_idx"]),
            jnp.asarray(inp["new_val"]), jnp.asarray(inp["new_sk"]),
            jnp.asarray(inp["new_codes"]),
            {k: jnp.asarray(v) for k, v in _state(inp).items()},
            new_codes2=jnp.asarray(inp["new_codes2"]))
    states, part, pos = _port_mutate(inp, tm, cell, 5)
    np.testing.assert_array_equal(part, np.asarray(r_part))
    np.testing.assert_array_equal(pos, np.asarray(r_pos))
    assert (part[48:] == -1).all()
    _assert_states_equal(st, states)


def test_delete_and_compact_steps_match_reference(one_shard):
    """Validity bitwise after the tombstones (padding and pairs past the
    last partition write nowhere), then ``new_pos`` and every slab array
    bitwise after compaction."""
    inp, jm, tm = one_shard
    cell = J.GusCellConfig(**CELL)
    jst = {k: jnp.asarray(v) for k, v in _state(inp).items()}
    with mesh_context(jm):
        jst = jax.jit(J.make_delete_step(jm, cell))(
            jnp.asarray(inp["del_parts"]), jnp.asarray(inp["del_poss"]), jst)
        jst2, new_pos = jax.jit(J.make_compact_step(jm, cell))(jst)
    tcell = T.GusCellConfig(**CELL)
    states = T.make_delete_step(tm, tcell)(
        torch.as_tensor(inp["del_parts"].astype(np.int64)),
        torch.as_tensor(inp["del_poss"].astype(np.int64)),
        _shard_arrays(_state(inp), tm))
    _assert_states_equal(jst, states)
    assert (T.global_array(states, "valid").numpy()
            != inp["valid"]).any()
    states2, t_pos = T.make_compact_step(tm, tcell)(states)
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(new_pos))
    _assert_states_equal(jst2, states2)


# ----------------------------------- several shards, against a subprocess

_REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.ann import sharded as J
    from repro.ann.sharded_index import ShardedConfig, ShardedGusIndex
    from repro.core import BucketConfig
    from repro.core.embedding import EmbeddingGenerator
    from repro.core.types import SparseBatch
    from repro.data.synthetic import OGB_ARXIV_LIKE, make_dataset
    from repro.launch.mesh import make_gus_mesh, make_test_mesh, mesh_context

    CELL = json.loads(sys.argv[2])
    STATE_KEYS = {state_keys!r}
    {step_inputs}
    out = {{}}
    inp = _step_inputs(1)
    out.update({{f"in_{{k}}": v for k, v in inp.items()}})
    state = {{k: jnp.asarray(inp[k]) for k in STATE_KEYS}}

    def run(tag, mesh, cell):
        with mesh_context(mesh):
            rows, dists = jax.jit(J.make_query_step(mesh, cell))(
                jnp.asarray(inp["q_idx"]), jnp.asarray(inp["q_val"]),
                jnp.asarray(inp["q_sk"]), state)
            out[f"{{tag}}_rows"], out[f"{{tag}}_dists"] = rows, dists
            if cell.merge == "hier":
                return
            soar = dataclasses.replace(cell, soar_lambda=1.0)
            st, (rp, rpos) = jax.jit(J.make_mutate_step(mesh, soar, 7))(
                jnp.asarray(inp["ids"]), jnp.asarray(inp["new_idx"]),
                jnp.asarray(inp["new_val"]), jnp.asarray(inp["new_sk"]),
                jnp.asarray(inp["new_codes"]), state,
                new_codes2=jnp.asarray(inp["new_codes2"]))
            st = jax.jit(J.make_delete_step(mesh, cell))(
                jnp.asarray(inp["del_parts"]), jnp.asarray(inp["del_poss"]),
                st)
            st2, new_pos = jax.jit(J.make_compact_step(mesh, cell))(st)
        out[f"{{tag}}_route_part"], out[f"{{tag}}_route_pos"] = rp, rpos
        out[f"{{tag}}_new_pos"] = new_pos
        for k in ("members_idx", "members_val", "codes", "row_ids", "valid",
                  "counts"):
            out[f"{{tag}}_mut_{{k}}"] = st[k]
            out[f"{{tag}}_cmp_{{k}}"] = st2[k]

    cell = J.GusCellConfig(**CELL)
    for n in (2, 4):
        run(f"s{{n}}", make_gus_mesh(n), cell)
    run("hier", make_test_mesh((2, 2), ("data", "model")),
        dataclasses.replace(cell, merge="hier"))
    mesh4 = make_gus_mesh(4)
    with mesh_context(mesh4):
        out["sparse_rows"], out["sparse_dists"] = jax.jit(
            J.make_query_step(mesh4, cell))(
            jnp.asarray(inp["q_idx"]), jnp.asarray(inp["q_val"]),
            jnp.asarray(inp["q_sk"]),
            dict(state, valid=jnp.asarray(inp["valid_sparse"])))

    # the index-level stream at 4 shards
    data = dataclasses.replace(OGB_ARXIV_LIKE, n_points=600, n_clusters=10)
    ids, feats, _ = make_dataset(data)
    gen = EmbeddingGenerator.create(
        data.spec, BucketConfig(dense_tables=8, dense_bits=10,
                                scalar_widths=(2.0,)))
    emb = gen(feats)
    out["ids"] = ids
    out["emb_idx"], out["emb_val"] = emb.indices, emb.values
    cfg = ShardedConfig(**json.loads(sys.argv[3]))
    idx = ShardedGusIndex(gen.k_max, cfg)
    idx.build(ids[:400], emb[:400])
    out["centroids"], out["books"] = idx.state["centroids"], idx.state["books"]
    meta = {{"slab": idx.slab, "salt": idx.salt, "stages": []}}

    def stage():
        occ = idx.occupancy()
        pids = np.asarray(sorted(idx.row_of), np.int64)
        rows = np.asarray([idx.row_of[p] for p in pids.tolist()], np.int64)
        i = len(meta["stages"])
        out[f"stage{{i}}_pids"], out[f"stage{{i}}_rows"] = pids, rows
        s_ids, s_d = idx.search(emb[:24], 6)
        out[f"stage{{i}}_search_ids"], out[f"stage{{i}}_search_d"] = s_ids, s_d
        meta["stages"].append(occ)

    stage()
    idx.upsert(ids[400:500], emb[400:500])
    idx.delete(ids[50:150])
    idx.upsert(ids[:30], emb[500:530])
    stage()
    idx.compact()
    stage()
    meta["moved"] = idx.resplit(1.0)
    stage()
    np.savez(sys.argv[1], **{{k: np.asarray(v) for k, v in out.items()}})
    print(json.dumps(meta))
""")

STREAM_CFG = dict(n_shards=4, d_proj=32, n_partitions=8, nprobe_local=0,
                  reorder=64, pq_m=4, kmeans_iters=4, pq_iters=2)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's multi-shard cases, once per module: one subprocess
    with four forced host devices writes an .npz of inputs and outputs."""
    import inspect
    code = _REFERENCE.format(
        state_keys=STATE_KEYS,
        step_inputs=textwrap.dedent(inspect.getsource(_step_inputs)))
    path = tmp_path_factory.mktemp("sharded_ref") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, str(path),
                          json.dumps(CELL), json.dumps(STREAM_CFG)],
                         env=env, capture_output=True, text=True, timeout=800)
    assert out.returncode == 0, out.stderr[-4000:]
    meta = json.loads(out.stdout.strip().splitlines()[-1])
    arrays = dict(np.load(path))
    return arrays, meta


def _inputs(arrays):
    return {k[3:]: v for k, v in arrays.items() if k.startswith("in_")}


@pytest.mark.slow
@pytest.mark.parametrize("tag", ["s2", "s4", "hier"])
def test_steps_match_reference_on_several_shards(reference_run, tag):
    """At 2 and 4 shards and on the 2x2 grid with the "hier" merge: the
    query step (ids exactly, distances bitwise), and at 2 and 4 shards
    the SOAR mutate step's routes, the tombstones and the compaction
    (every slab array and ``new_pos`` bitwise)."""
    arrays, _ = reference_run
    inp = _inputs(arrays)
    cell = dict(CELL, merge="hier" if tag == "hier" else "flat")
    mesh = (make_gus_mesh(4, two_level=True, device="cpu") if tag == "hier"
            else make_gus_mesh(int(tag[1:]), device="cpu"))
    fin = _assert_query_equal(arrays[f"{tag}_rows"], arrays[f"{tag}_dists"],
                              *_port_query(inp, mesh, cell))
    assert fin.mean() > 0.5
    if tag == "hier":
        assert mesh.shape == (2, 2) and mesh.axis_names == ("data", "model")
        return
    states, part, pos = _port_mutate(inp, mesh, dict(cell, soar_lambda=1.0),
                                     7)
    np.testing.assert_array_equal(part, arrays[f"{tag}_route_part"])
    np.testing.assert_array_equal(pos, arrays[f"{tag}_route_pos"])
    tcell = T.GusCellConfig(**cell)
    states = T.make_delete_step(mesh, tcell)(
        torch.as_tensor(inp["del_parts"].astype(np.int64)),
        torch.as_tensor(inp["del_poss"].astype(np.int64)), states)
    _assert_states_equal({k: arrays[f"{tag}_mut_{k}"] for k in ARRAYS},
                         states)
    states2, new_pos = T.make_compact_step(mesh, tcell)(states)
    np.testing.assert_array_equal(new_pos.numpy(), arrays[f"{tag}_new_pos"])
    _assert_states_equal({k: arrays[f"{tag}_cmp_{k}"] for k in ARRAYS},
                         states2)


@pytest.mark.slow
def test_query_step_pads_exhausted_shortlists(reference_run):
    """Four shards over a nearly empty index (fewer live rows in reach
    than top_k): the reference's distances bit for bit, +inf where the
    shortlists ran out, and there the port's row is -1."""
    arrays, _ = reference_run
    inp = _inputs(arrays)
    inp["valid"] = inp["valid_sparse"]
    fin = _assert_query_equal(arrays["sparse_rows"], arrays["sparse_dists"],
                              *_port_query(inp, make_gus_mesh(4, device="cpu"),
                                           CELL))
    assert 0 < fin.mean() < 1


@pytest.mark.slow
def test_index_stream_matches_reference(reference_run):
    """A 4-shard index from the reference's trained centroids and
    codebooks (``from_trained`` at its slab and salt) takes the
    reference's stream: the bootstrap load, 100 inserts, 100 deletes, 30
    updates, ``compact()``, a forced ``resplit(1.0)``. After each stage
    the id -> rows map and ``occupancy()`` equal the reference's field for
    field, and 24 searches at k=6 give its ids exactly and its distances
    within rtol 1e-6 / atol 1e-6."""
    arrays, meta = reference_run
    ids = arrays["ids"]
    emb = SparseBatch(torch.as_tensor(arrays["emb_idx"].astype(np.int64)),
                      torch.as_tensor(arrays["emb_val"]))
    idx = ShardedGusIndex.from_trained(
        emb.k, ShardedConfig(**STREAM_CFG), arrays["centroids"],
        arrays["books"], slab=meta["slab"], device="cpu")
    idx.restore_state({"salt": meta["salt"]})
    idx.upsert(ids[:400], emb[:400])
    moved = None

    def check(i):
        assert idx.occupancy() == meta["stages"][i], i
        pids = arrays[f"stage{i}_pids"]
        assert sorted(idx.row_of) == pids.tolist()
        np.testing.assert_array_equal(
            np.asarray([idx.row_of[p] for p in pids.tolist()]),
            arrays[f"stage{i}_rows"])
        s_ids, s_d = idx.search(emb[:24], 6)
        np.testing.assert_array_equal(s_ids, arrays[f"stage{i}_search_ids"])
        np.testing.assert_allclose(s_d, arrays[f"stage{i}_search_d"],
                                   rtol=1e-6, atol=1e-6)

    check(0)
    idx.upsert(ids[400:500], emb[400:500])
    idx.delete(ids[50:150])
    idx.upsert(ids[:30], emb[500:530])
    check(1)
    idx.compact()
    check(2)
    moved = idx.resplit(1.0)
    assert moved == meta["moved"] > 0
    check(3)


# -------------------------------------------- the port's own lifecycle

@pytest.fixture(scope="module")
def corpus():
    data = dataclasses.replace(OGB_ARXIV_LIKE, n_points=600, n_clusters=10)
    ids, feats, cluster = make_dataset(data)
    gen = EmbeddingGenerator.create(
        data.spec, BucketConfig(dense_tables=8, dense_bits=10,
                                scalar_widths=(2.0,)), "cpu")
    return ids, gen(feats), gen, cluster


def _index(k, **kw):
    return ShardedGusIndex(k, ShardedConfig(**dict(BASE, **kw)),
                           device="cpu")


def _brute(gen, ids, emb):
    brute = BruteIndex(gen.k_max, device="cpu")
    brute.upsert(np.asarray(ids, np.int64), emb)
    return brute


def test_mesh_placement_and_grids():
    """Every shard on the CPU; the two-level grid factors as the
    reference's; pods place as the rule says."""
    m = make_gus_mesh(4, device="cpu")
    assert m.shape == (4,) and m.axis_names == ("data",) and m.size == 4
    assert all(d == torch.device("cpu") for d in m.devices)
    assert make_gus_mesh(4, two_level=True, device="cpu").shape == (2, 2)
    assert make_gus_mesh(8, two_level=True, device="cpu").shape == (2, 4)
    assert make_gus_mesh(1, two_level=True, device="cpu").axis_names == \
        ("data", "model")
    assert len(make_pod_meshes(3, 2, device="cpu")) == 3


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_soar_two_copies_and_search_dedups(corpus, shards):
    """Every point lands in its primary and a distinct SOAR secondary
    partition of its owner shard, both holding its id; exhaustive search
    returns each id once and the brute oracle's distances (atol 1e-4, the
    reference's bar); the single-copy config keeps one row per point."""
    ids, emb, gen, _ = corpus
    idx = _index(gen.k_max, n_shards=shards)
    idx.build(ids, emb)
    valid = idx.array("valid")
    row_ids = idx.array("row_ids").reshape(-1)
    assert int(valid.sum()) == 2 * len(idx)
    c_loc = 8 // shards
    owners = (hashing.uhash(3, torch.as_tensor(ids)) % shards).numpy()
    for pid, owner in zip(ids[:100].tolist(), owners[:100].tolist()):
        r1, r2 = idx.row_of[pid]
        assert r1 // idx.slab != r2 // idx.slab
        assert r1 // idx.slab // c_loc == r2 // idx.slab // c_loc == owner
        assert row_ids[r1] == pid and row_ids[r2] == pid
    _, b_d = _brute(gen, ids, emb).search(emb[:24], 6)
    s_ids, s_d = idx.search(emb[:24], 6)
    np.testing.assert_allclose(np.sort(b_d, -1), np.sort(s_d, -1), atol=1e-4)
    for row in s_ids:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
    one = _index(gen.k_max, n_shards=shards,
                 maintenance=MaintenanceConfig(soar=-1.0))
    one.build(ids, emb)
    assert int(one.array("valid").sum()) == len(one)
    assert all(len(v) == 1 for v in one.row_of.values())


def test_compaction_bit_identical(corpus):
    """compact() squeezes tombstones out, keeps the host map exact
    against the slabs and is bitwise invisible to search (2 shards)."""
    ids, emb, gen, _ = corpus
    idx = _index(gen.k_max, n_shards=2)
    idx.build(ids, emb)
    idx.delete(ids[100:300])
    idx.upsert(ids[100:150], emb[100:150])
    i1, d1 = idx.search(emb[:32], 8)
    cursor_before = int(idx._cursor.sum())
    assert idx.compact()["reclaimed"] > 0
    assert int(idx._cursor.sum()) < cursor_before
    row_ids = idx.array("row_ids").reshape(-1)
    valid = idx.array("valid").reshape(-1)
    assert int(valid.sum()) == 2 * len(idx)
    for pid, rowvec in idx.row_of.items():
        for row in rowvec:
            assert valid[row] and row_ids[row] == pid
    i2, d2 = idx.search(emb[:32], 8)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


def _churn(gen, ids, emb, *, auto, shards):
    """Delete/insert churn that wraps deliberately small slabs (the
    reference's ``_churn``, 14 rounds)."""
    idx = ShardedGusIndex(gen.k_max, ShardedConfig(
        n_shards=shards, d_proj=32, n_partitions=4, slab=64, nprobe_local=0,
        reorder=4096, pq_m=4, kmeans_iters=4, pq_iters=2,
        maintenance=MaintenanceConfig(headroom=2.0, compact=auto)),
        device="cpu")
    n0 = 96
    idx.build(ids[:n0], emb[:n0])
    emb_of = {int(p): i for i, p in enumerate(ids[:n0].tolist())}
    live = list(ids[:n0].tolist())
    appends = 2 * n0
    rng = np.random.default_rng(7)
    next_id = 100_000
    for _ in range(14):
        sel = sorted(rng.choice(len(live), 16, replace=False), reverse=True)
        kill = [live.pop(int(j)) for j in sel]
        idx.delete(kill)
        for pid in kill:
            emb_of.pop(pid)
        new_ids = np.arange(next_id, next_id + 32, dtype=np.int64)
        next_id += 32
        srcs = rng.integers(0, len(ids), 32)
        idx.upsert(new_ids, emb[srcs])
        appends += 64
        live += new_ids.tolist()
        emb_of.update({int(p): int(s) for p, s in zip(new_ids, srcs)})
    return idx, set(live), emb_of, appends


@pytest.mark.parametrize("shards", [1, 2])
def test_wrap_churn_retains_live_rows(corpus, shards):
    """A churn stream whose appends exceed twice the built slabs: auto
    compaction (and slab growth) keeps every live row, aged_out == 0, and
    search matches the brute oracle over the survivors (atol 1e-4)."""
    ids, emb, gen, _ = corpus
    idx, live, emb_of, appends = _churn(gen, ids, emb, auto=True,
                                        shards=shards)
    assert appends >= 2 * 4 * 128
    occ = idx.occupancy()
    assert occ["aged_out"] == 0 and occ["compactions"] >= 1
    assert set(idx.row_of) == live
    assert int(idx.array("valid").sum()) == 2 * len(live)
    order = sorted(live)
    brute = _brute(gen, order, emb[np.asarray([emb_of[p] for p in order])])
    _, b_d = brute.search(emb[:16], 6)
    _, s_d = idx.search(emb[:16], 6)
    np.testing.assert_allclose(np.sort(b_d, -1), np.sort(s_d, -1),
                               atol=1e-4)


def test_wrap_churn_without_auto_compact_ages_out(corpus):
    """The contrast: with compact=False the ring wraps onto live rows
    and drops them."""
    ids, emb, gen, _ = corpus
    idx, live, _, _ = _churn(gen, ids, emb, auto=False, shards=2)
    assert idx.occupancy()["aged_out"] > 0
    assert len(idx.row_of) < len(live)


def _hot_ids(shards: int, count: int, to: int = 0, salt: int = 3):
    cand = torch.arange(1, 200_000, dtype=torch.int64)
    h = hashing.uhash(salt, cand) % shards
    return cand[h == to][:count].numpy()


def test_resplit_rebalances_hot_shard(corpus):
    """Ids that all hash to shard 0 of 4 (the armed policy at 1.5 also
    exercises the reentrancy guard: the salt bumps once): the re-split
    spreads them, ending where a fresh build at the final salt puts
    them, with the fresh build's distances (atol 1e-4)."""
    _, emb, gen, _ = corpus
    ids = _hot_ids(4, 600)
    cfg = dict(n_shards=4, reorder=4096,
               maintenance=MaintenanceConfig(resplit=1.5))
    idx = _index(gen.k_max, **cfg)
    idx.build(ids, emb)
    before = idx.occupancy()
    moved = idx.resplit(1.5)
    after = idx.occupancy()
    assert moved > 0 and idx.resplits == 1 and idx.salt == 4
    assert before["shard_imbalance"] > 3.9
    assert after["shard_imbalance"] < 2.0 and after["aged_out"] == 0
    fresh = _index(gen.k_max, **cfg)
    fresh.salt = idx.salt
    fresh.build(ids, emb)
    assert after["shard_live"] == fresh.occupancy()["shard_live"]
    _, d_split = idx.search(emb[:24], 6)
    _, d_fresh = fresh.search(emb[:24], 6)
    np.testing.assert_allclose(np.sort(d_split, -1), np.sort(d_fresh, -1),
                               atol=1e-4)


def test_resplit_by_query_load_moves_hot_read_shard(corpus):
    """Two shards balanced by occupancy whose reads all land on shard 0:
    the occupancy trigger sees nothing, the load trigger moves the hot
    shard's rows, resets the counters and keeps every answer (atol 1e-4;
    a re-split is placement only)."""
    _, emb, gen, cluster = corpus
    rows0 = np.flatnonzero(cluster == 0)[:40]
    rows1 = np.flatnonzero(cluster != 0)[:40]
    ids = np.concatenate([_hot_ids(2, 40, 0), _hot_ids(2, 40, 1)])
    order = np.concatenate([rows0, rows1])
    idx = _index(gen.k_max, n_shards=2, reorder=4096)
    idx.build(ids, emb[order])
    assert idx.occupancy()["shard_imbalance"] < 1.2
    q = emb[rows0[:16]]
    _, d_before = idx.search(q, 6)
    occ = idx.occupancy()
    assert occ["load_imbalance"] > 1.5
    assert idx.resplit(1.5, by="occupancy") == 0
    assert idx.resplit(1.5, by="load") > 0
    assert int(idx.query_load.sum()) == 0 and idx.salt == 4
    _, d_after = idx.search(q, 6)
    np.testing.assert_allclose(np.sort(d_before, -1), np.sort(d_after, -1),
                               atol=1e-4)


def test_query_load_counters_and_unknown_metric(corpus):
    """search() charges each returned candidate to its partition, build()
    resets the counters; an unknown skew metric is rejected by resplit()
    and by MaintenanceConfig."""
    ids, emb, gen, _ = corpus
    idx = _index(gen.k_max)
    idx.build(ids[:100], emb[:100])
    assert int(idx.query_load.sum()) == 0
    idx.search(emb[:16], 6)
    charged = int(idx.query_load.sum())
    occ = idx.occupancy()
    assert charged > 0 and occ["shard_load"] == [charged]
    assert occ["load_imbalance"] == 1.0
    assert idx.resplit(1.1) == 0 and idx.salt == 3      # one shard
    with pytest.raises(ValueError, match="resplit by"):
        idx.resplit(1.5, by="qps")
    with pytest.raises(ValueError, match="resplit_metric"):
        MaintenanceConfig(resplit_metric="qps")
    idx.build(ids[:50], emb[:50])
    assert int(idx.query_load.sum()) == 0


@pytest.mark.parametrize("merge", ["flat", "hier"])
def test_matches_brute_through_churn(corpus, merge):
    """One shard (flat) and four on a 2x2 grid (hier) against the brute
    oracle through insert, delete and reinsert
    (``tests/test_dynamic_equivalence.py:195,221``; atol 1e-4)."""
    ids, emb, gen, _ = corpus
    shards = 1 if merge == "flat" else 4
    idx = _index(gen.k_max, n_shards=shards, merge=merge)
    if merge == "hier":
        assert idx.mesh.axis_names == ("data", "model")
    idx.build(ids, emb)
    brute = _brute(gen, ids, emb)
    for index in (brute, idx):
        index.delete(ids[100:200])
        index.upsert(ids[100:150], emb[100:150])
    assert len(idx) == len(brute)
    _, b_d = brute.search(emb[:24], 6)
    _, s_d = idx.search(emb[:24], 6)
    np.testing.assert_allclose(np.sort(b_d, -1), np.sort(s_d, -1), atol=1e-4)


def test_backend_contract(corpus):
    """``tests/test_backend_protocol.py`` with "sharded": inserted points
    are their own nearest neighbor, deletes are idempotent and hide rows,
    the staged split composes to ``upsert``, and the salt survives a
    snapshot round trip so a rebuild searches the same way."""
    ids, emb, gen, _ = corpus
    idx = _index(gen.k_max, n_shards=2, reorder=512)
    idx.build(ids[:200], emb[:200])
    idx.upsert(ids[200:220], emb[200:220])
    assert len(idx) == 220
    got, dists = idx.search(emb[200:201], 3)
    assert got[0, 0] == ids[200] and dists[0, 0] < 0
    assert idx.delete(ids[200:205]) == 5
    assert idx.delete(ids[200:205]) == 0
    got, _ = idx.search(emb[200:201], 5)
    assert int(ids[200]) not in set(got[got >= 0].tolist())
    staged = idx.encode_upsert(ids[220:230], emb[220:230])
    idx.finish_upsert(idx.begin_upsert(ids[220:230], emb[220:230], staged))
    assert len(idx) == 225
    assert idx.search(emb[221:222], 1)[0][0, 0] == ids[221]
    idx.salt = 9
    fresh = _index(gen.k_max, n_shards=2, reorder=512)
    fresh.restore_state(idx.snapshot_state())
    assert fresh.salt == 9
    idx.build(ids[:200], emb[:200])
    fresh.build(ids[:200], emb[:200])
    for a, b in zip(idx.search(emb[:16], 5), fresh.search(emb[:16], 5)):
        np.testing.assert_array_equal(a, b)
