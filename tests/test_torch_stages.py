"""The stages of the port's RPCs (``repro_torch.obs.stage``): on the
profiler's clock while ``torch.profiler`` records, in the sampled trace
while one is active, and a shared no-op otherwise; the answers and the
index state the same bit for bit either way."""
import contextlib
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.ann.scann import ScannConfig
from repro_torch.core.buckets import BucketConfig
from repro_torch.core.gus import DynamicGUS, FeatureStore, GusConfig
from repro_torch.core.scorer import scorer_init
from repro_torch.core.types import MUTATION_DELETE
from repro_torch.data.stream import MutationStream, StreamConfig
from repro_torch.data.synthetic import (OGB_ARXIV_LIKE, OGB_PRODUCTS_LIKE,
                                        make_dataset)
from repro_torch.graph.store import GraphConfig
from repro_torch.serve.engine import GusEngine

ROOT = Path(__file__).resolve().parents[1]
DATA = dataclasses.replace(OGB_ARXIV_LIKE, n_points=300, n_clusters=6)
# ogbn-products' schema: a dense mode and a 16-slot set mode, no scalar
PRODUCTS = dataclasses.replace(OGB_PRODUCTS_LIKE, n_points=300, n_clusters=6)
SCANN = ScannConfig(d_proj=32, n_partitions=16, nprobe=4, reorder=64,
                    kmeans_iters=3, pq_iters=2)
BUCKETS = BucketConfig(dense_tables=8, dense_bits=10, scalar_widths=(2.0,))

# the stages of one neighborhood RPC by id through the index
READ_STAGES = {
    "gus.neighbors", "gus.gather", "gus.drop_self", "embed.batch",
    "embed.to_device", "embed.buckets", "embed.weights", "index.search",
    "index.sketch", "index.partitions", "index.shortlist", "index.rescore",
    "index.to_host", "index.id_map", "score.pairs", "score.to_host"}
# the program's layers, as its stage names start
LAYERS = ("gus", "embed", "index", "score", "mutate", "graph")
# the stages of one mutation RPC with a maintained graph
WRITE_STAGES = {
    "gus.mutate", "mutate.encode", "embed.batch", "mutate.apply",
    "index.delete", "index.write", "mutate.finish", "graph.apply",
    "graph.push_edges", "graph.repair"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gus(graph: bool = False, data=DATA) -> DynamicGUS:
    """A tiny engine on the CPU, bootstrapped from the first half of the
    corpus (the same state on every call)."""
    stream = MutationStream(data, StreamConfig(batch_size=16, seed=5), 0.5)
    cfg = GusConfig(scann_nn=5, scann=SCANN,
                    graph=GraphConfig(k=4, capacity=512) if graph else None)
    gus = DynamicGUS(data.spec, BUCKETS, scorer_init(0, data.spec,
                                                      device="cpu"),
                     cfg, device="cpu")
    gus.bootstrap(*stream.bootstrap())
    return gus, stream


@pytest.fixture(scope="module")
def world():
    return _gus()


def _profiled_stages(fn) -> tuple:
    """(result of ``fn``, [(name, start_us, end_us, meta)]) of the stages
    that ``fn`` opened under the CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    stages = []
    for e in prof.events():
        if e.name.startswith("span:"):
            base, sep, meta = e.name[len("span:"):].partition("|")
            stages.append((base, e.time_range.start, e.time_range.end,
                           json.loads(meta) if sep else None))
    return out, stages


def _leaves(stages: list) -> list:
    """The stages that hold no other stage."""
    return [a for i, a in enumerate(stages)
            if not any(j != i and a[1] <= b[1] and b[2] <= a[2]
                       for j, b in enumerate(stages))]


def _bits(a) -> np.ndarray:
    """An array's bytes, so -0.0 and +0.0 (and NaN payloads) differ."""
    return np.ascontiguousarray(a).view(np.uint8)


def _same_result(a, b) -> None:
    for x, y in ((a.ids, b.ids), (a.weights, b.weights),
                 (a.distances, b.distances)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


@pytest.mark.parametrize("rpc", ["neighbors_of_ids", "neighbors"])
def test_profiled_rpc_emits_every_stage_inside_its_root(world, rpc):
    """One neighborhood RPC under the CPU profiler: every stage of the
    read path once (the gather twice by id: the query rows and the
    candidates), each inside the one ``gus.neighbors``, every meta JSON."""
    gus, stream = world
    ids = gus.store.ids()[:7]
    if rpc == "neighbors_of_ids":
        _, stages = _profiled_stages(lambda: gus.neighbors_of_ids(ids, 5))
        want, gathers = READ_STAGES, 2
    else:
        feats = gus.store.gather(ids)
        _, stages = _profiled_stages(lambda: gus.neighbors(feats, 5))
        want, gathers = READ_STAGES - {"gus.drop_self"}, 1
    names = [s[0] for s in stages]
    assert set(names) == want
    assert names.count("gus.gather") == gathers
    roots = [s for s in stages if s[0] == "gus.neighbors"]
    assert len(roots) == 1
    _, r0, r1, meta = roots[0]
    assert meta == {"ids": 7, "k": 5}
    for name, s, e, _ in stages:
        assert r0 <= s <= e <= r1, name
    metas = {name: m for name, _, _, m in stages}
    assert metas["index.search"] == {"rows": 7,
                                     "k": 5 + (rpc == "neighbors_of_ids")}
    assert metas["score.pairs"]["rows"] == 7 * 5
    assert metas["embed.to_device"]["bytes"] > 0
    assert metas["embed.buckets"] is None
    # the store's counters: every row found, through the dense id table
    gather_metas = [m for name, _, _, m in stages if name == "gus.gather"]
    assert gather_metas[-1] == {"rows": 7 * 5, "missing": 0, "dense": True}
    if gathers == 2:
        assert gather_metas[0] == {"rows": 7, "missing": 0, "dense": True}


# the leaf stages of a neighborhood RPC by id on a schema without sets
READ_LEAVES = {
    "gus.gather", "embed.to_device", "embed.buckets", "embed.weights",
    "index.sketch", "index.partitions", "index.shortlist", "index.rescore",
    "index.to_host", "index.id_map", "gus.drop_self", "score.pairs",
    "score.to_host"}


@pytest.mark.parametrize("schema", ["products", "arxiv"])
def test_minhash_stage_opens_only_with_a_set_mode(world, schema):
    """A schema with a set mode runs its MinHash tables in a leaf stage
    ``embed.minhash`` inside ``embed.buckets``: an ``embed.`` leaf, so
    the ops it launches count among the embedding's (``launches_embed``
    gives a record to the leaf that last opened before it). Without sets
    no such stage opens and the leaves are the ones above."""
    gus, _ = _gus(data=PRODUCTS) if schema == "products" else world
    ids = gus.store.ids()[:7]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gus.neighbors_of_ids(ids, 5)
    stages, ops = [], []
    for e in prof.events():
        if e.name.startswith("span:"):
            base, sep, meta = e.name[len("span:"):].partition("|")
            stages.append((base, e.time_range.start, e.time_range.end,
                           json.loads(meta) if sep else None))
        elif e.name.startswith("aten::"):
            ops.append(e.time_range.start)
    leaves = sorted(_leaves(stages), key=lambda x: x[1])
    if schema == "arxiv":
        assert {s[0] for s in stages} == READ_STAGES
        assert {s[0] for s in leaves} == READ_LEAVES
        return
    assert {s[0] for s in stages} == READ_STAGES | {"embed.minhash"}
    assert {s[0] for s in leaves} == READ_LEAVES - {"embed.buckets"} \
        | {"embed.minhash"}
    (mh,) = [s for s in stages if s[0] == "embed.minhash"]
    (bk,) = [s for s in stages if s[0] == "embed.buckets"]
    assert bk[1] <= mh[1] <= mh[2] <= bk[2]
    assert mh[3] == {"tables": BUCKETS.set_tables, "cap": 16}
    owner = [next((n for n, s, _, _ in reversed(leaves) if s <= t), None)
             for t in ops]
    assert owner.count("embed.minhash") > 0


def test_write_path_emits_its_stages():
    """A mutation batch with deletes, under the profiler, on an engine
    with a maintained graph: the write path's stages inside
    ``gus.mutate``."""
    gus, stream = _gus(graph=True)
    batch = next(b for b in stream if (b.kinds == MUTATION_DELETE).any())
    _, stages = _profiled_stages(lambda: gus.mutate(batch))
    names = {s[0] for s in stages}
    assert WRITE_STAGES <= names
    root = next(s for s in stages if s[0] == "gus.mutate")
    assert root[3] == {"rows": 16}
    for name, s, e, _ in stages:
        assert root[1] <= s <= e <= root[2], name


def test_off_path_enters_no_record_function(world, monkeypatch):
    """With the profiler off and no active trace, an RPC enters no
    ``record_function`` and each stage is the one shared no-op."""
    gus, _ = world
    calls = []

    def counting(*a, **kw):
        calls.append(a)
        return contextlib.nullcontext()
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert obs.stage("gus.gather", rows=3) is obs.stage("index.sketch")
    gus.neighbors_of_ids(gus.store.ids()[:4], 5)
    assert calls == []


def test_answers_are_bitwise_the_same_with_stages_on_and_off():
    """The same engine state answers the same ids, weights and distances
    with the stages off, under the profiler and inside a sampled trace;
    the same mutation batch leaves the same index and graph."""
    off, stream = _gus(graph=True)
    on, _ = _gus(graph=True)
    batches = [next(stream) for _ in range(3)]
    tracer = obs.Tracer(sample_every=1)
    for batch in batches:
        off.mutate(batch)
        with tracer.activate(tracer.trace("mutate")):
            _profiled_stages(lambda: on.mutate(batch))
    for name in ("sp_idx", "sp_val", "members", "codes_list", "valid_list"):
        np.testing.assert_array_equal(
            _bits(getattr(off.index, name).numpy()),
            _bits(getattr(on.index, name).numpy()))
    assert off.index.slot_of == on.index.slot_of
    np.testing.assert_array_equal(_bits(off.graph.nbr_w.numpy()),
                                  _bits(on.graph.nbr_w.numpy()))
    np.testing.assert_array_equal(off.graph.nbr_slots.numpy(),
                                  on.graph.nbr_slots.numpy())
    ids = off.store.ids()[:9]
    # k above the graph's k: the index path, not the graph rows
    want = off.neighbors_of_ids(ids, 6)
    got, _ = _profiled_stages(lambda: on.neighbors_of_ids(ids, 6))
    _same_result(want, got)
    with tracer.activate(tracer.trace("query")):
        _same_result(want, on.neighbors_of_ids(ids, 6))


def test_engine_trace_nests_the_stages_under_the_answer():
    """``GusEngine`` at ``sample_every=1``: the member's stages are
    children of ``answer_primary`` in a well-formed trace."""
    gus, stream = _gus()
    engine = GusEngine(gus, telemetry=obs.Telemetry(sample_every=1))
    engine.query(stream.query_features(3), k=5)
    trace = engine.obs.tracer.finished[-1]
    assert trace.problems() == []
    (answer,) = [i for i, s in enumerate(trace.spans)
                 if s.name == "answer_primary"]
    assert "extra_ms" in trace.spans[answer].meta
    (root,) = trace.find("gus.neighbors")
    assert root.parent == answer
    assert root.meta == {"ids": 4, "k": 5}          # padded to a power of 2

    def ancestors(i):
        while i >= 0:
            yield i
            i = trace.spans[i].parent
    stages = [i for i, s in enumerate(trace.spans) if "." in s.name]
    assert {trace.spans[i].name for i in stages} == \
        READ_STAGES - {"gus.drop_self"}
    assert all(answer in ancestors(i) for i in stages)


def _program_stage_names() -> set:
    pat = re.compile(r"""\bstage\(\s*"([^"]+)\"""")
    return {m for path in (ROOT / "src" / "repro_torch").rglob("*.py")
            for m in pat.findall(path.read_text())}


def test_stage_names_are_apart_from_the_benchmark_spans():
    """Every stage the program opens is named ``<layer>.<step>`` with one
    of the program's layers, so it takes no name of a span that a caller
    opens around the program (bare words, ``rpc.*``, ``kernel.*``), and
    has no ``|`` (the meta separator)."""
    names = _program_stage_names()
    assert READ_STAGES | WRITE_STAGES <= names
    for name in names:
        layer, _, step = name.partition(".")
        assert layer in LAYERS and re.fullmatch(r"[a-z_]+", step), name


def test_gather_meta_counts_missing_rows_and_the_id_map():
    """``gus.gather``'s ``missing`` counts the rows not in the store (-1
    padding included) and ``dense`` says which id map served them: the
    dense table until an id near 2**40 turns the store to sorted keys."""
    store = FeatureStore(DATA.spec)
    feats = {k: v[:3] for k, v in make_dataset(DATA)[1].items()}
    store.put(np.asarray([0, 1, 2]), feats)
    probe = np.asarray([[2, -1], [10 ** 9, 0]])
    _, stages = _profiled_stages(lambda: store.gather(probe))
    assert [m for *_, m in stages] == [{"rows": 4, "missing": 2,
                                        "dense": True}]
    store.put(np.asarray([2 ** 40]), {k: v[:1] for k, v in feats.items()})
    _, stages = _profiled_stages(lambda: store.gather(probe))
    assert [m for *_, m in stages] == [{"rows": 4, "missing": 2,
                                        "dense": False}]


def test_meta_functions_run_only_when_the_stage_records():
    """A meta value given as a function is not called on the off path,
    and is called once, its value in the label, when the stage records."""
    calls = []

    def rows():
        calls.append(1)
        return 12

    def one_stage():
        with obs.stage("gus.gather", rows=rows):
            pass
    one_stage()
    assert calls == []
    _, stages = _profiled_stages(one_stage)
    assert calls == [1] and stages == [("gus.gather", *stages[0][1:3],
                                        {"rows": 12})]
