"""The serving plane's index hooks on the sharded backend, each held
against the reference: ``maintenance_pressure`` (the compaction
boundary), ``auto_resplit_on`` / ``auto_resplit`` (the armed re-split
pin and the maintenance worker's drain), ``publish`` (an
``IndexVersion`` that stays self-consistent across later writes and a
compaction), ``bind_telemetry`` and ``describe`` (``GusEngine``).

World: ``tests/_torch_world.py`` (``tests/test_pipeline.py``'s size);
the port's engines start from the reference's trained state
(``convert.load_bootstrapped``), so the two packages' pipelines see the
same stream from the same slabs and are compared event for event.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_world import (N_BOOT, SHARDED, assert_same_state, configs,
                          corpus, port_engine, ref_engine, streams)
from repro.core import MutationBatch as JMutationBatch
from repro.core.maintenance import MaintenanceConfig as JMaintenanceConfig
from repro.serve.engine import GusEngine as JGusEngine
from repro.serve.pipeline import MutationPipeline as JMutationPipeline
from repro.serve.pipeline import PipelineConfig as JPipelineConfig
from repro_torch.ann.sharded_index import IndexVersion
from repro_torch.core.maintenance import MaintenanceConfig
from repro_torch.core.types import MUTATION_INSERT, MutationBatch
from repro_torch.serve.engine import GusEngine
from repro_torch.serve.pipeline import MutationPipeline, PipelineConfig

TIGHT = dict(n_shards=1, d_proj=32, n_partitions=4, slab=64, nprobe_local=0,
             reorder=2048, pq_m=4, kmeans_iters=4, pq_iters=2,
             maintenance=dict(headroom=1.5))
ARMED = dict(SHARDED, maintenance=dict(resplit=1.5))


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


def _closes(pipe) -> list:
    return [(e["reason"], e["batches"], e["rows"])
            for e in pipe.obs.events.events("window_close")]


def _run_pair(world, sharded, seed, n, window=None, **stream_kw):
    """Both packages: a synchronous engine and a pipelined one each, the
    port's from the reference's trained state, through ``n`` batches of
    one stream. Returns (reference sync, reference pipe, port sync, port
    pipe, reference pipeline, port pipeline)."""
    ids, feats = world
    jcfg, tcfg = configs("sharded", sharded=sharded)
    j_sync, j_pipe_g = (ref_engine(jcfg, ids, feats) for _ in range(2))
    t_sync = port_engine(tcfg, ids, feats, j_sync)
    t_pipe_g = port_engine(tcfg, ids, feats, j_sync)
    pcfg = {} if window is None else {"window": window}
    jpipe = JMutationPipeline(j_pipe_g, JPipelineConfig(**pcfg))
    tpipe = MutationPipeline(t_pipe_g, PipelineConfig(**pcfg))
    batches = [streams(seed, **stream_kw) for _ in range(2)]
    for _, ja, ta, jb, tb in zip(range(n), *batches[0], *batches[1]):
        j_sync.mutate(ja)
        jpipe.submit(jb)
        t_sync.mutate(ta)
        tpipe.submit(tb)
    jpipe.flush()
    tpipe.flush()
    return j_sync, j_pipe_g, t_sync, t_pipe_g, jpipe, tpipe


@pytest.mark.parametrize("mix", ["churn", "inserts"])
def test_compaction_boundary_matches_reference(world, mix):
    """Tight slabs (``headroom=1.5``): a stream forces compactions and
    slab growth inside ``begin_upsert``. ``churn`` is the reference's
    stream (``tests/test_pipeline.py:158``: deletes in every batch, which
    close every window); ``inserts`` has none, so windows fuse until
    ``maintenance_pressure`` closes them. Either way pipelined ==
    synchronous bit for bit (slabs, id maps, a probe), the lifecycle ran
    as often as in the reference, the ``window_close`` events (reason,
    batches, rows) equal the reference's, and so do the placements and
    ``occupancy()``."""
    kw = (dict(insert_frac=0.6, update_frac=0.1) if mix == "churn"
          else dict(insert_frac=1.0, update_frac=0.0))
    j_sync, _, t_sync, t_pipe, jpipe, tpipe = _run_pair(
        world, TIGHT, 21, 14, **kw)
    assert t_sync.index.compactions >= 1
    for g in (t_sync, t_pipe):
        assert g.index.compactions == j_sync.index.compactions
        assert g.index.slab_grows == j_sync.index.slab_grows
        assert g.index.aged_out == 0
    # before any probe: searches charge the query-load counters
    assert t_sync.index.row_of == j_sync.index.row_of
    assert t_sync.index.occupancy() == j_sync.index.occupancy()
    assert_same_state(t_sync, t_pipe, graph=False)
    assert _closes(tpipe) == _closes(jpipe)
    reasons = {r for r, _, _ in _closes(tpipe)}
    assert ("pressure" in reasons) == (mix == "inserts")
    if mix == "inserts":
        assert tpipe.windows < 14                        # some windows fused


def test_armed_resplit_pins_window_matches_reference(world):
    """An armed re-split policy pins the fuse window to 1 and runs the
    trigger on the synchronous schedule: salt, window closes and state
    as the reference's, pipelined == synchronous bit for bit."""
    j_sync, _, t_sync, t_pipe, jpipe, tpipe = _run_pair(
        world, ARMED, 31, 6, insert_frac=0.7, update_frac=0.2)
    assert tpipe.window_size() == 1 == jpipe.window_size()
    assert t_pipe.index.salt == t_sync.index.salt == j_sync.index.salt
    assert tpipe.windows == 6 == jpipe.windows
    assert _closes(tpipe) == _closes(jpipe)
    assert t_sync.index.row_of == j_sync.index.row_of
    assert_same_state(t_sync, t_pipe, graph=False)


def test_armed_resplit_fires_in_the_pipeline(world):
    """Port only, two shards in this process: ids that all hash to
    shard 0 make the armed trigger fire at the pipeline's window
    boundary; the twin runs the synchronous schedule (the trigger, then
    the batch: ``DynamicGUS.mutate`` alone never re-splits, in the
    reference either) and ends in the same state bit for bit."""
    from repro_torch.core import hashing
    ids, feats = world
    _, tcfg = configs("sharded", sharded=dict(ARMED, n_shards=2))
    cand = torch.arange(1, 100_000, dtype=torch.int64)
    hot = cand[hashing.uhash(3, cand) % 2 == 0][:len(ids)].numpy()
    engines = [port_engine(tcfg, hot, feats) for _ in range(2)]
    sync_g, pipe_g = engines
    pipe = MutationPipeline(pipe_g)
    assert pipe.window_size() == 1
    rows = np.arange(N_BOOT, N_BOOT + 64)
    for lo in range(0, 64, 16):
        sel = rows[lo:lo + 16]
        batch = MutationBatch(
            kinds=np.full(16, MUTATION_INSERT, np.int32), ids=hot[sel],
            features={k: v[sel] for k, v in feats.items()})
        sync_g.index.auto_resplit()
        sync_g.mutate(batch)
        pipe.submit(batch)
    pipe.flush()
    assert sync_g.index.resplits >= 1
    assert pipe_g.index.resplits == sync_g.index.resplits
    assert pipe_g.index.salt == sync_g.index.salt > 3
    assert_same_state(sync_g, pipe_g, graph=False)


def _snapshot(ver: IndexVersion) -> dict:
    from repro_torch.ann.sharded import global_array
    return {k: global_array(ver.state, k).numpy().copy()
            for k in ("members_idx", "row_ids", "valid", "counts")}


def test_maintenance_plane_publishes_index_versions(world):
    """The maintenance plane at staleness bound 4 on the sharded backend
    with a maintained graph (``tests/test_maintenance_plane.py:83``): the
    lag stays within the bound; the drain runs the armed re-split
    (``auto_resplit_on``) and publishes an ``IndexVersion``; the
    ``snapshot_swap`` events (plane, seq, version) equal the reference
    pipeline's. The published version stays self-consistent, and
    unchanged, across later writes and a compaction."""
    ids, feats = world
    jcfg, tcfg = configs("sharded", graph=True)
    # GusConfig.maintenance is canonical: it reaches the graph and the index
    jcfg = dataclasses.replace(jcfg, maintenance=JMaintenanceConfig(
        staleness_bound=4, resplit=1.5))
    tcfg = dataclasses.replace(tcfg, maintenance=MaintenanceConfig(
        staleness_bound=4, resplit=1.5))
    jg = ref_engine(jcfg, ids, feats)
    tg = port_engine(tcfg, ids, feats, jg)
    assert tg.maintenance.staleness_bound == 4
    assert tg.index.auto_resplit_on
    jpipe = JMutationPipeline(jg, JPipelineConfig(window=8))
    tpipe = MutationPipeline(tg, PipelineConfig(window=8))
    assert tpipe.window_size() == 4 == jpipe.window_size()
    calls = []
    trigger = tg.index.auto_resplit
    tg.index.auto_resplit = lambda: calls.append(1) or trigger()
    jstream, tstream = streams(11)
    for _, jb, tb in zip(range(8), jstream, tstream):
        jpipe.submit(jb)
        tpipe.submit(tb)
        assert 0 <= tg.seq_applied - tg.graph.view().seq <= 4
    jpipe.flush()
    tpipe.flush()
    assert calls
    ver = tg.index.published()
    assert isinstance(ver, IndexVersion) and ver.seq == tg.seq_applied

    def swaps(pipe):
        return [(e["plane"], e["seq"], e["version"])
                for e in pipe.obs.events.events("snapshot_swap")]

    assert swaps(tpipe) == swaps(jpipe)
    assert ("index", tg.seq_applied, ver.version) in swaps(tpipe)
    before = _snapshot(ver)
    valid = before["valid"].reshape(-1)
    np.testing.assert_array_equal(
        ver.id_of_row[valid], before["row_ids"].reshape(-1)[valid])
    assert int(valid.sum()) == ver.points * tg.index.cfg.n_copies
    for _, tb in zip(range(3), tstream):
        tg.mutate(tb)
    tg.index.compact()
    assert tg.index.version > ver.version
    for key, arr in _snapshot(ver).items():
        np.testing.assert_array_equal(arr, before[key], err_msg=key)
    assert tg.index.published() is ver


def test_engine_binds_index_telemetry_and_describes(world):
    """``GusEngine`` binds its primary's sharded index into the engine's
    registry (the ``index_*`` instruments, as the reference's engine
    has) and reports ``describe()["index"]`` equal to the reference's
    after one batch of 16 inserts; the inserted point finds itself."""
    ids, feats = world
    jcfg, tcfg = configs("sharded")
    jg = ref_engine(jcfg, ids, feats)
    tg = port_engine(tcfg, ids, feats, jg)
    jeng, teng = JGusEngine(jg), GusEngine(tg)
    names = {n for n in teng.obs.registry.names() if n.startswith("index_")}
    assert names == {n for n in jeng.obs.registry.names()
                     if n.startswith("index_")}
    assert len(names) == 9
    assert tg.index.obs is teng.obs
    sel = slice(200, 216)
    for eng, kind in ((jeng, JMutationBatch), (teng, MutationBatch)):
        eng.submit_mutations(kind(
            kinds=np.full(16, MUTATION_INSERT, np.int32), ids=ids[sel],
            features={k: v[sel] for k, v in feats.items()}))
    assert len(tg.index) == N_BOOT + 16
    assert teng.describe()["index"] == jeng.describe()["index"]
    got = teng.query({k: v[200:201] for k, v in feats.items()}, k=3)
    want = jeng.query({k: v[200:201] for k, v in feats.items()}, k=3)
    assert got.ids[0, 0] == ids[200]
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-6,
                               atol=1e-6)
    tg.index.compact()
    assert teng.obs.registry.get("index_compactions_total").value == 1
    assert teng.describe()["index"]["compactions"] == 1


def test_write_path_never_synchronizes_the_device(world, monkeypatch):
    """``mutate`` and the pipeline on two shards with tight slabs
    (compactions inside ``begin_upsert``) reach no
    ``torch.cuda.synchronize``; on the CPU the batch's barrier handle is
    None (the card's is a CUDA event: tests/test_torch_sharded_cuda.py)."""
    ids, feats = world
    _, tcfg = configs("sharded", sharded=dict(TIGHT, n_shards=2))
    gus = port_engine(tcfg, ids, feats)

    def refuse(*args, **kwargs):
        raise AssertionError("the write path synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    stream = streams(17)[1]
    staged = gus.encode_mutation(next(iter(stream)))
    gus.apply_mutation(staged)
    assert staged.pending["event"] is None
    gus.finish_mutation(staged)
    for _, batch in zip(range(6), stream):
        gus.mutate(batch)
    pipe = MutationPipeline(gus)
    for _, batch in zip(range(6), stream):
        pipe.submit(batch)
    pipe.flush()
    assert gus.index.compactions >= 1 and gus.index.aged_out == 0


def test_engine_snapshot_carries_the_salt(world):
    """``convert.engine_snapshot`` of a reference sharded engine whose
    salt a re-split bumped: a port engine restored from it takes the salt
    (as an int) and routes every point by it, here over two shards."""
    from repro_torch import convert
    from repro_torch.core import hashing
    from _torch_world import port_raw
    ids, feats = world
    jcfg, _ = configs("sharded")
    jg = ref_engine(jcfg, ids, feats)
    jg.index.restore_state({"salt": 5})
    conv = convert.engine_snapshot(jg.snapshot_state())
    assert conv["index"] == {"salt": 5}
    assert type(conv["index"]["salt"]) is int
    _, tcfg = configs("sharded", sharded=dict(SHARDED, n_shards=2))
    tg = port_raw(tcfg)
    tg.restore_state(conv)
    assert tg.index.salt == 5 and len(tg.index) == N_BOOT
    c_loc = tg.index.cfg.n_partitions // 2
    pids = np.asarray(sorted(tg.index.row_of))
    owners = (hashing.uhash(5, torch.as_tensor(pids)) % 2).numpy()
    np.testing.assert_array_equal(
        [tg.index.row_of[p][0] // tg.index.slab // c_loc
         for p in pids.tolist()], owners)
