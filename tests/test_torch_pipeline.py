"""The port's write path: ``MutationPipeline`` and the maintenance plane.

* pipelined == synchronous inside the port, bit for bit (index arrays and
  id maps, graph rows, CC labels), brute and scann, with a graph (the
  window pinned to 1) and with fused windows
  (``tests/test_pipeline.py:124``, ``:141``);
* the window-closing rules fire as the reference's do on one batch
  script (the ``window_close`` events' reasons, batches and rows), and
  the port's pipeline then answers as the reference's (brute; scann at
  the reference's trained state, slot layout bitwise);
* bounded staleness at bounds 1 and 2, and bound 0 bitwise the
  synchronous path (``tests/test_maintenance_plane.py:84``, ``:147``);
* the write barrier is the batch's CUDA event: no path through
  ``mutate`` or the pipeline reaches ``torch.cuda.synchronize`` (on the
  card: ``tests/test_torch_pipeline_cuda.py``).

World: ``tests/_torch_world.py``.
"""
import numpy as np
import pytest
import torch

from _torch_world import (N_BOOT, assert_same_state, configs, corpus,
                          port_engine, port_stream, ref_engine)
from repro.core import MutationBatch as JMutationBatch
from repro.serve.pipeline import MutationPipeline as JMutationPipeline
from repro.serve.pipeline import PipelineConfig as JPipelineConfig
from repro_torch.core.types import (MUTATION_DELETE, MUTATION_INSERT,
                                    MUTATION_UPDATE, MutationBatch)
from repro_torch.graph.cc import offline_components
from repro_torch.serve.pipeline import MutationPipeline, PipelineConfig
from test_torch_gus import _assert_same_neighbors


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


def _cc_exact(gus) -> bool:
    return gus.graph.components() == offline_components(
        gus.graph.edges()[0], np.asarray(sorted(gus.graph.slot_of)))


# ------------------------------------------------ pipelined == synchronous

@pytest.mark.parametrize("backend", ["brute", "scann"])
def test_pipeline_matches_sync_with_graph(world, backend):
    """Insert/update/delete interleavings with a maintained graph (the
    window pinned to 1): index, graph rows and CC bit for bit."""
    ids, feats = world
    _, tcfg = configs(backend, graph=True)
    sync_g = port_engine(tcfg, ids, feats)
    pipe_g = port_engine(tcfg, ids, feats)
    pipe = MutationPipeline(pipe_g)
    for _, a, b in zip(range(6), port_stream(5), port_stream(5)):
        sync_g.mutate(a)
        pipe.submit(b)
    pipe.flush()
    assert pipe.window_size() == 1
    assert_same_state(sync_g, pipe_g)
    assert _cc_exact(pipe_g)
    assert pipe.describe()["repair_backlog"] == \
        sync_g.graph.repair_backlog()


@pytest.mark.parametrize("backend", ["brute", "scann"])
def test_pipeline_matches_sync_fused_windows(world, backend):
    """Without a graph, upsert-only windows fuse: still bit for bit the
    per-batch path, across deletes that close windows."""
    ids, feats = world
    _, tcfg = configs(backend)
    sync_g = port_engine(tcfg, ids, feats)
    pipe_g = port_engine(tcfg, ids, feats)
    pipe = MutationPipeline(pipe_g)
    kw = dict(insert_frac=0.7, update_frac=0.2)
    for _, a, b in zip(range(8), port_stream(9, **kw), port_stream(9, **kw)):
        sync_g.mutate(a)
        pipe.submit(b)
    pipe.flush()
    assert pipe.windows <= pipe.submitted // 16        # something fused
    assert_same_state(sync_g, pipe_g)


# ---------------------------------------- the window-closing rules, shared

def _script(ids, feats, stream):
    """Hand-made batches that hit every rule a graph-free pipeline has
    (duplicate ids, a delete, an update of a live id), then the stream."""
    def batch(kind, rows, pids):
        return (np.full(len(pids), kind, np.int32), np.asarray(pids),
                {k: v[rows] for k, v in feats.items()})
    fresh = list(range(N_BOOT + 120, N_BOOT + 140))
    out = [batch(MUTATION_INSERT, fresh[0:4], ids[fresh[0:4]]),
           batch(MUTATION_INSERT, fresh[4:8], ids[fresh[4:8]]),
           batch(MUTATION_INSERT, fresh[0:4], ids[fresh[0:4]]),
           batch(MUTATION_DELETE, [0], ids[fresh[0:1]]),
           batch(MUTATION_INSERT, fresh[8:12], ids[fresh[8:12]]),
           batch(MUTATION_UPDATE, [3, 4], ids[[3, 4]])]
    out += [(b.kinds, b.ids, b.features) for _, b in zip(range(4), stream)]
    return out


@pytest.mark.parametrize("backend", ["brute", "scann"])
def test_window_close_reasons_and_answers_match_reference(world, backend):
    """One batch script through both packages' pipelines (window 4): the
    same ``window_close`` events (reason, batches, rows), the same
    counters; then the port answers as the reference (scann: its slot
    and slab layout equal to the reference's)."""
    ids, feats = world
    jcfg, tcfg = configs(backend)
    jg = ref_engine(jcfg, ids, feats)
    tg = port_engine(tcfg, ids, feats, jg)
    jpipe = JMutationPipeline(jg, JPipelineConfig(window=4))
    tpipe = MutationPipeline(tg, PipelineConfig(window=4))
    for kinds, pids, f in _script(ids, feats, port_stream(12)):
        jpipe.submit(JMutationBatch(kinds=kinds, ids=pids, features=f))
        tpipe.submit(MutationBatch(kinds=kinds, ids=pids, features=f))
    jpipe.flush()
    tpipe.flush()
    want = [(e["reason"], e["batches"], e["rows"])
            for e in jpipe.obs.events.events("window_close")]
    got = [(e["reason"], e["batches"], e["rows"])
           for e in tpipe.obs.events.events("window_close")]
    assert got == want
    reasons = {r for r, _, _ in got}
    assert {"duplicate_ids", "delete"} <= reasons
    if backend == "scann":
        assert "updates_live" in reasons
    for key in ("submitted", "windows", "ticks"):
        assert tpipe.describe()[key] == jpipe.describe()[key], key
    assert set(tg.store.ids().tolist()) == set(jg.store._rows)
    if backend == "scann":
        assert tg.index.slot_of == jg.index.slot_of
    qids = np.asarray(sorted(jg.store._rows))[:16]
    _assert_same_neighbors(jg._index_neighbors_of_ids(qids, 5),
                           tg._index_neighbors_of_ids(qids, 5), 5)


# ---------------------------------------------- the maintenance plane

@pytest.mark.parametrize("backend,bound", [("brute", 1), ("scann", 2)])
def test_bounded_staleness_property(world, backend, bound):
    """Mutate/query interleavings with ``staleness_bound`` B: the view
    serving reads never lags the applied stream by more than B batches,
    versions are monotone, each hand-off leaves the worker within B, and
    quiescence is exact."""
    ids, feats = world
    _, tcfg = configs(backend, graph=True, bound=bound)
    gus = port_engine(tcfg, ids, feats)
    pipe = MutationPipeline(gus, PipelineConfig(window=8))
    assert pipe.window_size() == min(8, bound)
    rng = np.random.default_rng(101 * bound + len(backend))
    boot_ids = np.asarray(ids[:N_BOOT])
    observed = []

    def serve_point():
        view = gus.graph.view()
        lag = gus.seq_applied - view.seq
        assert 0 <= lag <= bound, (lag, bound)
        assert pipe.worker.lag() <= bound
        observed.append((view.version, lag))

    for _, batch in zip(range(8), port_stream(7 + bound)):
        pipe.submit(batch)
        serve_point()
        if rng.random() < 0.7:
            res = gus.neighbors_of_ids(rng.choice(boot_ids, 4,
                                                  replace=False), k=4)
            assert res.ids.shape == (4, 4)
            serve_point()
    assert max(lag for _, lag in observed) > 0     # the plane ran
    versions = [v for v, _ in observed]
    assert versions == sorted(versions)
    assert pipe.worker.ticks > 0
    pipe.flush()
    assert pipe.worker.pending() == 0 and pipe.worker.lag() == 0
    assert gus.graph.view().seq == gus.seq_applied
    assert _cc_exact(gus)
    reg = pipe.obs.registry
    assert reg.get("maintenance_ticks_total").value == pipe.worker.ticks
    assert reg.get("maintenance_lag").value == 0


@pytest.mark.parametrize("backend", ["brute", "scann"])
def test_bound_zero_is_bitwise_sync(world, backend):
    """``GusConfig(maintenance=MaintenanceConfig(staleness_bound=0))``:
    the window pins to 1, nothing is deferred, state bit for bit sync."""
    ids, feats = world
    _, tcfg = configs(backend, graph=True, bound=0)
    sync_g = port_engine(tcfg, ids, feats)
    pipe_g = port_engine(tcfg, ids, feats)
    pipe = MutationPipeline(pipe_g)
    assert pipe.window_size() == 1
    for _, a, b in zip(range(4), port_stream(13), port_stream(13)):
        sync_g.mutate(a)
        pipe.submit(b)
    pipe.flush()
    assert pipe.worker.pending() == 0 and pipe.worker.ticks == 0
    assert_same_state(sync_g, pipe_g)
    assert _cc_exact(pipe_g)


# ------------------------------------------------------ the write barrier

def _never_synchronize(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the write path synchronised the device")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def test_write_path_never_synchronizes_the_device(world, monkeypatch):
    """``mutate`` and the pipeline (with a graph and the plane) reach no
    ``torch.cuda.synchronize``; on the CPU the barrier handle is None."""
    ids, feats = world
    _, tcfg = configs("scann", graph=True, bound=1)
    gus = port_engine(tcfg, ids, feats)
    _never_synchronize(monkeypatch)
    stream = port_stream(17)
    staged = gus.encode_mutation(next(iter(stream)))
    gus.apply_mutation(staged)
    assert staged.pending is None
    gus.finish_mutation(staged)
    gus.mutate(next(iter(stream)))
    pipe = MutationPipeline(gus)
    for _, batch in zip(range(3), stream):
        pipe.submit(batch)
    pipe.flush()
