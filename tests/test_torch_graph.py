"""The port's maintained graph against the reference, on the CPU: the
``topk_select`` wrapper (plain version) against the reference kernel in
interpret mode, ``DynamicGraphStore`` driven step by step through one
seeded interleaving in both packages, a continuation from a reference
snapshot, published-view immutability, ``core/graph.py`` / ``core/grale.py``
/ ``graph/cc.py``, and a small engine with ``GraphConfig(k=5)``.

Tolerances: top-k, the adjacency (slots and weights), slot maps, the free
list, the repair queue, the edge counters, CC labels and rounds are
bitwise or equal. The engine test compares graphs built from scored
neighborhoods whose sums run in another order than the reference's: edge
sets agree except at near-ties of the ANN cut, and weights of shared
edges within atol 1e-5 (the scorer's tolerance in test_torch_gus.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import grale as jgrale
from repro.core.types import NeighborResult as JNeighborResult
from repro.graph import cc as jcc
from repro.graph.store import DynamicGraphStore as JStore
from repro.graph.store import GraphConfig as JGraphConfig
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import graph as tgraph
from repro_torch.core import grale as tgrale
from repro_torch.core.maintenance import MaintenanceConfig
from repro_torch.core.types import NeighborResult
from repro_torch.graph import cc as tcc
from repro_torch.graph.store import DynamicGraphStore, GraphConfig
from repro_torch.kernels import ops

assert jax.default_backend() == "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    one machine, and torch's default of one thread per core oversubscribes
    it against the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------- top-k

def _topk_scores(case: str) -> tuple:
    rng = np.random.default_rng(11)
    scores = rng.choice(np.asarray([-np.inf, -1.0, 0.0, 0.5, 3.0],
                                   np.float32), size=(6, 40))
    if case == "ties":
        return scores, 8
    if case == "all -inf rows":
        scores[[0, 3]] = -np.inf
        return scores, 8
    if case == "k=N":
        return scores, 40
    return rng.normal(size=(3, 100)).astype(np.float32), 80   # k > 64


@pytest.mark.parametrize("case", ["ties", "all -inf rows", "k=N", "k>64"])
def test_topk_select_matches_reference_bitwise(case):
    """ops.topk_select against the reference's (its Pallas kernel in
    interpret mode for k <= 64, lax.top_k above): values, -inf placement
    and the lowest-index order at ties."""
    scores, k = _topk_scores(case)
    want = jops.topk_select(jnp.asarray(scores), k, interpret=True)
    before = ops.launch_counts()["topk_select"]
    got = ops.topk_select(torch.as_tensor(scores), k)
    assert ops.launch_counts()["topk_select"] == before   # CPU: plain version
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if case == "all -inf rows":
        assert (got[1][0].numpy() == np.arange(k)).all()


# ------------------------------------------------------------ the store

def _results(ids_rows, w_rows):
    ids = np.asarray(ids_rows, np.int64)
    w = np.asarray(w_rows, np.float32)
    d = np.zeros_like(w)
    return (JNeighborResult(ids=ids, weights=w, distances=d),
            NeighborResult(ids=ids, weights=w, distances=d))


def _assert_same_store(js: JStore, ts: DynamicGraphStore, where: str,
                       counted_before: tuple = (0, 0)):
    """``counted_before``: the reference's edge counters when the port's
    store started (a snapshot does not carry them)."""
    np.testing.assert_array_equal(ts.nbr_slots.numpy(),
                                  np.asarray(js.nbr_slots), err_msg=where)
    np.testing.assert_array_equal(ts.nbr_w.numpy(), np.asarray(js.nbr_w),
                                  err_msg=where)
    np.testing.assert_array_equal(ts.ids_dev.numpy(), np.asarray(js.ids_dev))
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    np.testing.assert_array_equal(ts.labels.numpy(), np.asarray(js.labels))
    np.testing.assert_array_equal(ts.id_of_slot, js.id_of_slot)
    assert ts.slot_of == js.slot_of, where
    assert ts._free == js._free, where
    assert ts.capacity == js.capacity, where
    assert sorted(ts._repair) == sorted(js._repair), where
    assert (ts.edges_added + counted_before[0],
            ts.edges_removed + counted_before[1]) == (js.edges_added,
                                                      js.edges_removed), where


def _random_step(rng, live: list, n_ids: int = 150):
    """One seeded operation: ("upsert", ids, rows, weights) or ("delete",
    ids). Upserts draw up to 4 neighbors from the live pool."""
    if rng.random() < 0.65 or len(live) < 6:
        batch = list(dict.fromkeys(
            int(p) for p in rng.integers(0, n_ids, rng.integers(1, 5))))
        pool = list(dict.fromkeys(live + batch))
        rows_i, rows_w = [], []
        for pid in batch:
            nbrs = [p for p in pool if p != pid]
            rng.shuffle(nbrs)
            nbrs = nbrs[:4]
            rows_i.append(nbrs + [-1] * (4 - len(nbrs)))
            # weights from few values: ties inside rows
            rows_w.append([float(rng.choice([0.25, 0.5, 0.75, 0.9]))
                           for _ in nbrs] + [-np.inf] * (4 - len(nbrs)))
        return ("upsert", batch, rows_i, rows_w), pool
    sel = sorted({live[int(rng.integers(len(live)))]
                  for _ in range(int(rng.integers(1, 3)))})
    return ("delete", sel), [p for p in live if p not in sel]


def _apply(op, js: JStore, ts: DynamicGraphStore):
    if op[0] == "upsert":
        jr, tr = _results(op[2], op[3])
        js.upsert(np.asarray(op[1]), jr)
        ts.upsert(np.asarray(op[1]), tr)
    elif op[0] == "delete":
        assert js.delete(np.asarray(op[1])) == ts.delete(np.asarray(op[1]))
    else:                                  # repair drain: re-merge, no purge
        rep = js.take_repair_ids(op[1])
        np.testing.assert_array_equal(ts.take_repair_ids(op[1]), rep)
        if rep.size:
            live = sorted(js.slot_of)
            rows = [[p for p in live if p != r][:3] for r in rep.tolist()]
            rows = [r + [-1] * (3 - len(r)) for r in rows]
            w = [[0.3 if p >= 0 else -np.inf for p in r] for r in rows]
            jr, tr = _results(rows, w)
            js.upsert(rep, jr, purge=False)
            ts.upsert(rep, tr, purge=False)


def _hub_step(live: list, start: int) -> tuple:
    """70 new points that all link to the first live point: more than
    _MAX_CANDS pushes into one row (two merge rounds) and evictions past
    the row width, mirrored."""
    hub = live[0]
    batch = list(range(start, start + 70))
    rows = [[hub, -1] for _ in batch]
    w = [[0.1 + 0.01 * i, -np.inf] for i in range(len(batch))]
    return ("upsert", batch, rows, w), list(dict.fromkeys(live + batch))


def test_store_random_interleaving_bitwise():
    """Upserts, deletes, repair drains, growth (capacity 64 -> 256) and
    overflow evictions in one seeded interleaving: after every step the
    adjacency is bitwise the reference's and the host state equal; CC
    labels and rounds equal at every few steps."""
    rng = np.random.default_rng(3)
    js = JStore(JGraphConfig(k=3, width=6, capacity=64))
    ts = DynamicGraphStore(GraphConfig(k=3, width=6, capacity=64),
                           device="cpu")
    live: list = []
    for step in range(40):
        if step == 20:
            op, live = _hub_step(live, 1000)
        elif step % 7 == 6:
            op = ("repair", 4)
        else:
            op, live = _random_step(rng, live)
        _apply(op, js, ts)
        _assert_same_store(js, ts, f"step {step} {op[0]}")
        if step % 5 == 4:
            assert ts.components() == js.components(), step
            assert ts.cc_iters == js.cc_iters, step
            _assert_same_store(js, ts, f"step {step} components")
    assert ts.capacity > 64
    assert ts.edges()[0].shape == js.edges()[0].shape
    np.testing.assert_array_equal(ts.edges()[1], js.edges()[1])
    assert ts.describe() == js.describe()


def test_store_continues_from_reference_snapshot():
    """A reference store's snapshot carried across with
    convert.graph_state: both packages continue one stream from one
    adjacency, bitwise."""
    rng = np.random.default_rng(8)
    js = JStore(JGraphConfig(k=3, width=6, capacity=64))
    live: list = []
    for _ in range(12):
        op, live = _random_step(rng, live)
        if op[0] == "upsert":
            js.upsert(np.asarray(op[1]), _results(op[2], op[3])[0])
        else:
            js.delete(np.asarray(op[1]))
    ts = convert.graph_state(js.snapshot_state(), device="cpu")
    assert ts.cfg.row_width() == 6 and ts.cfg.k == 3
    counted = (js.edges_added, js.edges_removed)
    _assert_same_store(js, ts, "restored", counted)
    for step in range(10):
        op, live = _random_step(rng, live)
        _apply(op, js, ts)
        _assert_same_store(js, ts, f"continued step {step}", counted)
    assert ts.components() == js.components()
    assert ts.cc_iters == js.cc_iters


def test_graph_view_is_immutable():
    """A published view does not change when the store mutates after it
    (the port updates the adjacency in place, so publish copies it)."""
    ts = DynamicGraphStore(GraphConfig(k=2, width=4, capacity=64),
                           device="cpu")
    tr = _results([[1, 2], [0, 2], [0, 1]],
                  [[0.9, 0.5], [0.9, 0.7], [0.5, 0.7]])[1]
    ts.upsert(np.asarray([0, 1, 2]), tr)
    view = ts.publish(seq=3)
    slots, w = view.nbr_slots.clone(), view.nbr_w.clone()
    before = view.neighbors_of_ids([0, 2], k=2)
    ts.delete([1])
    ts.upsert(np.asarray([5]), _results([[0, 2]], [[0.99, 0.98]])[1])
    assert torch.equal(view.nbr_slots, slots) and torch.equal(view.nbr_w, w)
    after = view.neighbors_of_ids([0, 2], k=2)
    np.testing.assert_array_equal(after.ids, before.ids)
    np.testing.assert_array_equal(after.weights, before.weights)
    assert view.has_ids([1]) and not ts.has_ids([1])
    assert ts.view() is view and view.seq == 3
    assert ts.neighbors_of_ids([0], k=2).ids[0].tolist() == [5, 2]


# -------------------------------------------------- graph / grale / cc

def test_graph_grale_and_cc_match_reference():
    rng = np.random.default_rng(4)
    pairs = rng.integers(0, 60, (300, 2))
    w = rng.choice(np.asarray([0.1, 0.4, 0.6, 0.9], np.float32), 300)
    # core/graph.py: canonicalisation, the accumulator, the metrics
    for fn in ("canonical_max_edges",):
        for got, want in zip(getattr(tgraph, fn)(pairs[:, 0], pairs[:, 1], w),
                             getattr(jgraph, fn)(pairs[:, 0], pairs[:, 1], w)):
            np.testing.assert_array_equal(got, want)
    accs = [tgraph.GraphAccumulator(), jgraph.GraphAccumulator()]
    res = _results(pairs[:40, :1].tolist(), w[:40, None].tolist())
    for acc, r in zip(accs, (res[1], res[0])):
        acc.add_pairs(pairs[40:], w[40:])
        acc.add_result(pairs[:40, 1], r)
    for got, want in zip(accs[0].edges(), accs[1].edges()):
        np.testing.assert_array_equal(got, want)
    assert tgraph.edge_weight_percentiles(w) == jgraph.edge_weight_percentiles(w)
    assert tgraph.frac_above(w, 0.5) == jgraph.frac_above(w, 0.5)
    assert tgraph.edge_sets_equal(pairs, pairs[:, ::-1])
    # core/grale.py: the bucket join and top-k pruning are numpy
    buckets = rng.integers(0, 25, (60, 3)).astype(np.uint32)
    valid = rng.random((60, 3)) > 0.2
    for cfg in (jgrale.GraleConfig(), jgrale.GraleConfig(bucket_split=3)):
        tcfg = tgrale.GraleConfig(bucket_split=cfg.bucket_split)
        np.testing.assert_array_equal(
            tgrale.scoring_pairs(buckets, valid, tcfg),
            jgrale.scoring_pairs(buckets, valid, cfg))
    uniq, best = jgraph.canonical_max_edges(pairs[:, 0], pairs[:, 1], w)
    np.testing.assert_array_equal(
        tgrale.top_k_per_point(uniq, best, 60, 3),
        jgrale.top_k_per_point(uniq, best, 60, 3))
    # graph/cc.py: hash-to-min from a partial frontier, labels and rounds
    cap, width = 64, 5
    nbr = np.full((cap, width), -1, np.int32)
    for a, b in uniq[best > 0.3][:90].tolist():
        for x, y in ((a, b), (b, a)):
            free = np.flatnonzero(nbr[x] < 0)
            if free.size and y not in nbr[x]:
                nbr[x, free[0]] = y
    nbr[np.isin(nbr, np.flatnonzero((nbr >= 0).sum(1) == width))] = -1
    alive = np.arange(cap) < 60
    labels = np.where(alive, np.arange(cap), jcc.DEAD_LABEL).astype(np.int32)
    active = rng.random(cap) < 0.5
    want = jcc.propagate_labels(jnp.asarray(labels), jnp.asarray(nbr),
                                jnp.asarray(alive), jnp.asarray(active))
    got = tcc.propagate_labels(torch.as_tensor(labels), torch.as_tensor(nbr),
                               torch.as_tensor(alive), torch.as_tensor(active))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1] == int(want[1]) > 1
    ids = np.arange(60)
    assert tcc.offline_components(uniq, ids) == jcc.offline_components(
        uniq, ids)
    assert tcc.propagate_flags(uniq, best, ids, [3, 7]) == \
        jcc.propagate_flags(uniq, best, ids, [3, 7])


# ---------------------------------------------------------- the engine

def test_engine_graph_matches_reference():
    """Bootstrap (chunked seeding + repair flush), one mutation batch with
    graph maintenance, then the fast neighborhood read, in both packages
    from one trained state (GraphConfig(k=5): width 40). Edge sets agree
    except at near-ties of the ANN cut; shared edges' weights within atol
    1e-5; the port's CC is exact (equal to union-find over its edges)."""
    from test_torch_gus import _pair

    jg, tg, jstream, tstream = _pair(
        "scann", graph=(JGraphConfig(k=5), GraphConfig(k=5)))
    for _, jb, tb in zip(range(1), jstream, tstream):
        jg.mutate(jb)
        tg.mutate(tb)
    jp, jw = jg.graph.edges()
    tp, tw = tg.graph.edges()
    jset = {tuple(p) for p in jp.tolist()}
    tset = {tuple(p) for p in tp.tolist()}
    assert len(jset ^ tset) <= 0.02 * len(jset), (len(jset ^ tset), len(jset))
    jmap = dict(zip(map(tuple, jp.tolist()), jw.tolist()))
    shared = [(w, jmap[p]) for p, w in zip(map(tuple, tp.tolist()),
                                           tw.tolist()) if p in jmap]
    np.testing.assert_allclose(*np.asarray(shared).T, atol=1e-5, rtol=0)
    # symmetric adjacency and an exact CC
    s = tg.graph.nbr_slots.numpy()
    for r, c in zip(*np.nonzero(s >= 0)):
        assert (s[s[r, c]] == r).sum() == 1
    assert tg.graph.components() == tcc.offline_components(
        tp, np.asarray(sorted(tg.graph.slot_of)))
    # the fast path serves from the graph rows (no index search)
    qids = tstream.query_ids(8)
    before = tg.query_timer.samples_ms[:]
    got = tg.neighbors_of_ids(qids, k=5)
    want = tg.graph.neighbors_of_ids(qids, k=5)
    np.testing.assert_array_equal(got.ids, want.ids)
    assert len(tg.query_timer.samples_ms) == len(before) + 1
    jres = jg.neighbors_of_ids(qids, k=5)
    same = (jres.ids == got.ids).mean()
    assert same >= 0.9, same
    # staleness_bound > 0: reads go through the published view, which
    # does not see graph changes made after it was published
    tg.maintenance = MaintenanceConfig(staleness_bound=1)
    tg.graph.publish(seq=tg.seq_applied)
    gone = int(got.ids[0, 0])
    tg.graph.delete([gone])
    stale = tg.neighbors_of_ids(qids[:1], k=5)
    np.testing.assert_array_equal(stale.ids, got.ids[:1])
    assert gone not in tg.graph.neighbors_of_ids(qids[:1], k=5).ids
