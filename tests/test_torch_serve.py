"""The port's serving plane: ``GusEngine`` (recovery, hedging, fail-over,
catch-up), ``Frontend`` (admission) and ``launch/serve.py``.

* engine recovery with and without a snapshot, a double crash, hedges
  round-robin over replicas, fail-over, ``ServingUnavailableError`` when
  every member is dead, catch-up after a kill and after a partition (log
  suffix replay, and re-bootstrap when a snapshot truncated the log);
* one fault script through a reference engine and a port engine (brute,
  one replica each, the same state): the same counters, events and
  per-member records, and answers within ``_assert_same_neighbors``'
  tolerance. Hedges are decided by injected straggler ms only (slow by
  10^6 ms against a 10^5 ms deadline), never by measured time;
* the front-end's admission contract on a fixed clock: bounded queues,
  explicit shedding, per-class order, pipelined == synchronous, and the
  registry reconciling — its counters equal to the reference front-end's
  under one schedule;
* ``python -m repro_torch.launch.serve --device cpu`` with ``jax`` and
  ``repro`` blocked.

World: ``tests/_torch_world.py`` (brute backend).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_world import (N_BOOT, DATA, J_DATA, assert_same_state, configs,
                          corpus, port_engine, port_raw, ref_engine)
from repro.data.stream import MutationStream as JStream
from repro.data.stream import StreamConfig as JStreamConfig
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import Frontend as JFrontend
from repro.serve import FrontendConfig as JFrontendConfig
from repro.serve import GusEngine as JGusEngine
from repro.serve import ServingUnavailableError as JUnavailable
from repro_torch.core.types import MUTATION_INSERT, MutationBatch
from repro_torch.data.stream import MutationStream, StreamConfig
from repro_torch.serve import (EngineConfig, FaultInjector, Frontend,
                               FrontendConfig, GusEngine,
                               ServingUnavailableError)
from test_torch_gus import _assert_same_neighbors

ROOT = Path(__file__).resolve().parent.parent
PRIMARY = FaultInjector.PRIMARY


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world():
    return corpus()


def _gus(world, bootstrap=True):
    _, tcfg = configs("brute")
    if not bootstrap:
        return port_raw(tcfg)
    return port_engine(tcfg, *world)


def _stream(seed, batch=16):
    return MutationStream(DATA, StreamConfig(batch_size=batch, seed=seed),
                          0.5)


def _q(feats, lo, n=1):
    return {k: v[lo:lo + n] for k, v in feats.items()}


def _same_answers(a, b):
    """Two engines over one corpus answer alike. A restore re-bootstraps
    (slots in id order, not in history's), so ids may swap only inside a
    tie at the cut: ``_assert_same_neighbors``, on the index path."""
    assert set(a.store.ids().tolist()) == set(b.store.ids().tolist())
    qids = a.store.ids()[::7][:24]
    _assert_same_neighbors(a._index_neighbors_of_ids(qids, 5),
                           b._index_neighbors_of_ids(qids, 5), 5)


# ------------------------------------------------------------ recovery

def test_recover_replays_log_without_snapshot(world):
    ids, feats = world
    engine = GusEngine(_gus(world), EngineConfig(snapshot_every=1000))
    for _, mb in zip(range(5), _stream(2)):
        engine.submit_mutations(mb)
    assert len(engine.mutation_log) == 5 and engine.snapshot_state is None
    engine2 = engine.recover(_gus(world))
    assert len(engine2.mutation_log) == 5 and engine2.seq == 5
    assert_same_state(engine.gus, engine2.gus)      # the same op sequence


def test_recover_from_snapshot_with_replicas_and_double_crash(world):
    """Snapshot after 2 batches, 1 in the log: recovery restores the
    snapshot into the fresh primary and replica and replays the log; a
    second crash before the next snapshot keeps the snapshot corpus."""
    engine = GusEngine(_gus(world), EngineConfig(snapshot_every=2))
    for _, mb in zip(range(3), _stream(3)):
        engine.submit_mutations(mb)
    assert engine.snapshot_state is not None
    assert len(engine.mutation_log) == 1
    engine2 = engine.recover(_gus(world, False),
                             replicas=[_gus(world, False)])
    assert len(engine2.replicas) == 1
    _same_answers(engine.gus, engine2.gus)
    assert_same_state(engine2.gus, engine2.replicas[0])
    engine3 = engine2.recover(_gus(world, False))
    assert engine3.snapshot_state is engine.snapshot_state
    assert_same_state(engine2.gus, engine3.gus)


# ------------------------------------------------- hedging and fail-over

def test_hedge_uses_replicas_round_robin(world):
    ids, feats = world
    engine = GusEngine(_gus(world), EngineConfig(hedge_ms=-1.0),
                       replicas=[_gus(world), _gus(world)])
    r1 = engine.query(_q(feats, 0), k=5)
    r2 = engine.query(_q(feats, 0), k=5)
    assert engine.hedged == 2 and engine.replica_hedges == [1, 1]
    np.testing.assert_array_equal(r1.ids, r2.ids)
    assert engine.describe()["replica_hedges"] == [1, 1]


def test_failover_and_all_dead_is_unavailable(world):
    ids, feats = world
    faults = FaultInjector()
    engine = GusEngine(_gus(world), EngineConfig(), replicas=[_gus(world)],
                       faults=faults)
    want = engine.query(_q(feats, 7, 3), k=5)
    faults.kill(PRIMARY)
    got = engine.query(_q(feats, 7, 3), k=5)
    np.testing.assert_array_equal(got.ids, want.ids)
    assert engine.failovers == 1
    assert engine.obs.events.last("failover")["member"] == "replica:0"
    faults.kill(0)
    with pytest.raises(ServingUnavailableError, match="no eligible member"):
        engine.query(_q(feats, 7), k=5)
    assert engine.obs.registry.get("engine_unavailable_total").value == 1
    faults.revive(PRIMARY)
    assert engine.query(_q(feats, 7), k=5).ids.shape == (1, 5)


@pytest.mark.parametrize("fault", ["kill", "partition"])
def test_catch_up_replays_the_log_suffix(world, fault):
    """A killed (or partitioned) replica misses two batches; revived (or
    healed), the next query's catch-up brings it back and it answers as
    the primary does. The snapshot at batch 3 truncated the log, so that
    catch-up re-bootstraps from the snapshot; a later one replays the
    log suffix."""
    faults = FaultInjector()
    engine = GusEngine(_gus(world), EngineConfig(snapshot_every=3),
                       replicas=[_gus(world)], faults=faults)
    replica = engine.replica_set.members[0]
    stream = _stream(4)
    engine.submit_mutations(next(iter(stream)))
    getattr(faults, fault)(0)
    for _, mb in zip(range(2), stream):
        engine.submit_mutations(mb)
    assert replica.applied_seq == 1 and engine.seq == 3
    faults.revive(0) if fault == "kill" else faults.heal(0)
    _, feats = world
    engine.query(_q(feats, 3), k=5)
    assert replica.applied_seq == engine.seq and replica.catchups == 1
    ev = engine.obs.events.last("catch_up")
    assert ev["member"] == "replica:0" and ev["rebootstrapped"]
    _same_answers(engine.gus, replica.gus)
    # without a snapshot in between: a pure log-suffix replay
    getattr(faults, fault)(0)
    engine.submit_mutations(next(iter(stream)))
    faults.revive(0) if fault == "kill" else faults.heal(0)
    assert engine.catch_up() == 1
    assert not engine.obs.events.last("catch_up")["rebootstrapped"]
    _same_answers(engine.gus, replica.gus)
    # the snapshot at seq 3 emptied the log: the re-bootstrap replayed
    # none of it, the later catch-up one batch
    assert engine.describe()["replicas"][0]["caught_up_batches"] == 1


# -------------------------------------- one fault script, both packages

def _fault_script(engine, faults, feats, stream, unavailable):
    """Batches, queries and scripted faults; returns the answers."""
    answers = []

    def ask(lo):
        answers.append(engine.query(_q(feats, N_BOOT + lo, 4), k=5))

    batches = iter(stream)
    engine.submit_mutations(next(batches))
    ask(0)
    faults.slow(faults.PRIMARY, 1e6)                   # hedge
    ask(10)
    faults.clear_slow(faults.PRIMARY)
    faults.kill(faults.PRIMARY)                        # fail-over
    ask(20)
    engine.submit_mutations(next(batches))             # primary misses it
    faults.revive(faults.PRIMARY)                      # catch-up
    ask(30)
    faults.partition(0)
    engine.submit_mutations(next(batches))
    ask(40)                                            # replica ineligible
    faults.heal(0)
    faults.kill(faults.PRIMARY)
    ask(50)                                            # catch-up, fail-over
    faults.kill(0)
    with pytest.raises(unavailable):
        ask(60)
    faults.revive(faults.PRIMARY)
    faults.revive(0)
    ask(70)
    return answers


def test_engine_counters_match_reference_under_one_fault_script(world):
    ids, feats = world
    jcfg, tcfg = configs("brute")
    jg, jrep = ref_engine(jcfg, ids, feats), ref_engine(jcfg, ids, feats)
    tg = port_engine(tcfg, ids, feats, jg)
    trep = port_engine(tcfg, ids, feats, jg)
    jfaults, tfaults = JFaultInjector(), FaultInjector()
    jeng = JGusEngine(jg, JEngineConfig(hedge_ms=1e5, snapshot_every=2),
                      replicas=[jrep], faults=jfaults)
    teng = GusEngine(tg, EngineConfig(hedge_ms=1e5, snapshot_every=2),
                     replicas=[trep], faults=tfaults)
    want = _fault_script(jeng, jfaults, feats,
                         JStream(J_DATA, JStreamConfig(batch_size=16,
                                                       seed=6), 0.5),
                         JUnavailable)
    got = _fault_script(teng, tfaults, feats, _stream(6),
                        ServingUnavailableError)
    for w, g in zip(want, got):
        _assert_same_neighbors(w, g, 5)
    assert tfaults.log == jfaults.log
    jd, td = jeng.describe(), teng.describe()
    for key in ("queries", "hedged", "failovers", "seq", "replica_hedges",
                "primary", "replicas"):
        assert td[key] == jd[key], key
    assert (teng.hedged, teng.failovers) == (1, 2)
    jreg, treg = jeng.obs.registry, teng.obs.registry
    for name in jreg.names():
        if name.startswith("engine_") and name.endswith("_total"):
            assert treg.get(name).value == jreg.get(name).value, name
    assert [(e.kind, e.fields.get("member")) for e in teng.obs.events] == \
        [(e.kind, e.fields.get("member")) for e in jeng.obs.events]
    assert teng.serving.count == jeng.serving.count


# ------------------------------------------------------------ front-end

class _Clock:
    """A fixed clock: each read advances 1 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _frontend(world, fcfg, ecfg=EngineConfig(), replicas=0, faults=None):
    engine = GusEngine(_gus(world), ecfg,
                       replicas=[_gus(world) for _ in range(replicas)],
                       faults=faults)
    return Frontend(engine, fcfg, clock=_Clock())


def test_bounded_queue_and_explicit_shedding(world):
    fcfg = FrontendConfig(query_queue=5, mutate_queue=3, query_dispatch=2,
                          mutate_dispatch=1)
    fe = _frontend(world, fcfg)
    stream = _stream(5, batch=8)
    responses = [fe.submit_query(stream.query_features(1), k=4)
                 for _ in range(8)]
    assert [r.status for r in responses] == \
        ["accepted"] * 5 + ["shed_capacity"] * 3
    assert all(r.terminal and r.shed and r.detail for r in responses[5:])
    rng = np.random.default_rng(11)
    for _ in range(120):
        op = rng.integers(3)
        if op == 0:
            fe.submit_query(stream.query_features(1), k=4)
        elif op == 1:
            fe.submit_mutation(next(stream))
        else:
            fe.step()
        assert fe.queue_depth("query") <= fcfg.query_queue
        assert fe.queue_depth("mutate") <= fcfg.mutate_queue
    fe.drain()
    assert fe.queue_high_water == {"query": 5, "mutate": 3}


def test_backpressure_sheds_mutations_not_queries(world):
    fe = _frontend(world, FrontendConfig(query_queue=64, mutate_queue=64,
                                         mutate_dispatch=4,
                                         max_unflushed=20),
                   EngineConfig(pipeline=True))
    stream = _stream(5, batch=8)
    statuses = [fe.submit_mutation(next(stream)).status for _ in range(8)]
    assert "shed_backpressure" in statuses
    assert set(statuses) <= {"accepted", "shed_backpressure"}
    assert fe.submit_query(stream.query_features(1), k=4).status == \
        "accepted"
    out = fe.drain()
    assert any(r.kind == "query" and r.status == "ok" for r in out)
    assert fe.submit_mutation(next(stream)).status == "accepted"
    fe.drain()


def test_admission_order_and_no_loss(world):
    """Every accepted request completes exactly once, in admission order
    per class; a dead plane answers with an explicit error."""
    faults = FaultInjector()
    fe = _frontend(world, FrontendConfig(query_queue=8, mutate_queue=4,
                                         query_dispatch=3,
                                         mutate_dispatch=2),
                   replicas=1, faults=faults)
    stream = _stream(9, batch=8)
    rng = np.random.default_rng(23)
    admitted = {"query": [], "mutate": []}
    completed = {"query": [], "mutate": []}
    for i in range(120):
        if i == 60:
            faults.kill(PRIMARY)
            faults.kill(0)
        if i == 70:
            faults.revive(PRIMARY)
        op = rng.integers(4)
        if op <= 1:
            r = fe.submit_query(stream.query_features(1), k=4)
        elif op == 2:
            r = fe.submit_mutation(next(stream))
        else:
            for done in fe.step():
                completed[done.kind].append(done.rid)
            continue
        if r.status == "accepted":
            admitted[r.kind].append(r.rid)
        else:
            assert r.terminal
    for done in fe.drain():
        completed[done.kind].append(done.rid)
    assert completed == admitted
    assert fe.errors > 0


def test_pipelined_frontend_equals_sync_path(world):
    fcfg = FrontendConfig(query_queue=256, mutate_queue=256,
                          query_dispatch=4, mutate_dispatch=2,
                          max_unflushed=10**9)
    results = {}
    for pipelined in (False, True):
        fe = _frontend(world, fcfg, EngineConfig(pipeline=pipelined))
        stream = _stream(31, batch=8)
        rng = np.random.default_rng(31)
        out = {}
        for _ in range(50):
            op = rng.integers(4)
            if op <= 1:
                fe.submit_query(stream.query_features(1), k=5)
            elif op == 2:
                fe.submit_mutation(next(stream))
            else:
                out.update((r.rid, r.result) for r in fe.step()
                           if r.kind == "query")
        out.update((r.rid, r.result) for r in fe.drain()
                   if r.kind == "query")
        results[pipelined] = out
    assert results[True].keys() == results[False].keys()
    for rid, res in results[False].items():
        for f in ("ids", "weights", "distances"):
            np.testing.assert_array_equal(getattr(res, f),
                                          getattr(results[True][rid], f))


def test_registry_reconciles_and_matches_reference(world):
    """Randomized traffic through a reference and a port front-end on one
    schedule: accepted == completed + errors per class, the shed split
    sums to the sheds, one ``admission_shed`` event each, the engine's
    query count bounded by the completions; and every front-end and
    engine counter equal to the reference's."""
    ids, feats = world
    jcfg, tcfg = configs("brute")
    jg = ref_engine(jcfg, ids, feats)
    tg = port_engine(tcfg, ids, feats, jg)
    kw = dict(query_queue=6, mutate_queue=3, query_dispatch=2,
              mutate_dispatch=1)
    # hedges only from injected time: a deadline no measured call reaches
    jfe = JFrontend(JGusEngine(jg, JEngineConfig(hedge_ms=1e5)),
                    JFrontendConfig(**kw), clock=_Clock())
    tfe = Frontend(GusEngine(tg, EngineConfig(hedge_ms=1e5)),
                   FrontendConfig(**kw), clock=_Clock())
    jstream = JStream(J_DATA, JStreamConfig(batch_size=8, seed=3), 0.5)
    tstream = _stream(3, batch=8)
    for fe, stream in ((jfe, jstream), (tfe, tstream)):
        rng = np.random.default_rng(7)
        for _ in range(90):
            op = rng.integers(3)
            if op == 0:
                fe.submit_query(stream.query_features(1), k=4)
            elif op == 1:
                fe.submit_mutation(next(stream))
            else:
                fe.step()
        fe.drain()
    reg = tfe.obs.registry
    val = lambda name: reg.get(name).value                  # noqa: E731
    for kind in ("query", "mutate"):
        assert (val(f"frontend_completed_{kind}_total")
                + (val("frontend_errors_total") if kind == "query" else 0)
                == tfe.accepted[kind])
        assert reg.get(f"frontend_queue_wait_{kind}_ms").count \
            == tfe.completed[kind]
        assert val(f"frontend_queue_depth_{kind}") == 0
    total_shed = tfe.shed["query"] + tfe.shed["mutate"]
    assert total_shed > 0
    assert val("frontend_shed_capacity_total") \
        + val("frontend_shed_backpressure_total") == total_shed
    assert len(tfe.obs.events.events("admission_shed")) == total_shed
    assert tfe.obs is tfe.engine.obs
    assert 0 < tfe.engine.queries <= tfe.completed["query"]
    jreg = jfe.obs.registry
    for name in jreg.names():
        if name.endswith("_total") and name.startswith(
                ("frontend_", "engine_")):
            assert reg.get(name).value == jreg.get(name).value, name
    assert tfe.describe()["queue_high_water"] == \
        jfe.describe()["queue_high_water"]


# ------------------------------------------------------------ launcher

_LAUNCH = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.argv = ["serve"] + sys.argv[1:]
runpy.run_module("repro_torch.launch.serve", run_name="__main__")
"""


def test_launch_serve_runs_on_the_cpu_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _LAUNCH, "--device", "cpu", "--points", "600",
         "--mutations", "4", "--queries", "8"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "[serve] bootstrapped 360 points"
    assert any(line.startswith("[serve] after batch 0:") for line in lines)
    blob = json.loads(out.stdout[out.stdout.index("\n{") + 1:])
    assert blob["seq"] == 4 and blob["mutation_latency"]["n"] == 4
    assert blob["query_latency"]["n"] >= 1


def test_launch_serve_sharded_backend_raises():
    """(The name is kept from when ``--backend sharded`` raised.) The
    launcher serves from two index shards on the CPU, with jax blocked:
    a few batches, the probes' same-cluster lines, and the index's slab
    occupancy in the engine's ``describe()``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _LAUNCH, "--device", "cpu", "--points", "600",
         "--mutations", "4", "--queries", "8", "--backend", "sharded",
         "--shards", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "[serve] bootstrapped 360 points"
    assert any(line.startswith("[serve] after batch 0:") for line in lines)
    blob = json.loads(out.stdout[out.stdout.index("\n{") + 1:])
    assert blob["seq"] == 4 and blob["mutation_latency"]["n"] == 4
    assert len(blob["index"]["shard_live"]) == 2
    assert blob["index"]["aged_out"] == 0


def test_engine_query_pads_to_a_power_of_two(world):
    """Five query rows run as a batch of 8 (the last row repeated) and
    come back as five rows equal to five single-row answers."""
    ids, feats = world
    engine = GusEngine(_gus(world))
    calls = []
    orig = engine.gus.neighbors

    def spy(f, k=None, exclude_ids=None):
        calls.append(next(iter(f.values())).shape[0])
        return orig(f, k, exclude_ids)

    engine.gus.neighbors = spy
    res = engine.query(_q(feats, 20, 5), k=5)
    assert calls == [8] and res.ids.shape == (5, 5)
    for r in range(5):
        one = engine.query(_q(feats, 20 + r), k=5)
        np.testing.assert_array_equal(one.ids[0], res.ids[r])


def test_insert_is_visible_to_the_next_query_through_the_pipeline(world):
    """Read-your-writes across the async write path."""
    ids, feats = world
    engine = GusEngine(_gus(world), EngineConfig(pipeline=True))
    lo = N_BOOT + 50
    engine.submit_mutations(MutationBatch(
        kinds=np.full(8, MUTATION_INSERT, np.int32), ids=ids[lo:lo + 8],
        features=_q(feats, lo, 8)))
    assert engine.pipelines[0].in_flight
    res = engine.query(_q(feats, lo), k=3)
    assert not engine.pipelines[0].in_flight
    assert res.ids[0, 0] == ids[lo]
    assert engine.describe()["pipeline"]["submitted"] == 8
