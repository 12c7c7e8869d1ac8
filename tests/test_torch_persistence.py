"""The port's persistence against the reference's: ``FeatureStore``'s
snapshot, ``DynamicGUS.snapshot_state`` -> ``restore_state`` (brute
backend: exact, so the two packages' restored engines are comparable),
``convert.engine_snapshot`` of a reference snapshot, ``periodic_reload``,
and a scann restore repeated (it retrains, torch-seeded, so it is held
against itself). World: ``tests/_torch_world.py``. Ids equal but at
near-ties of the cut; weights and distances within the tolerance of
``test_torch_gus._assert_same_neighbors``."""
import numpy as np
import pytest
import torch

from _torch_world import (DATA, J_DATA, N_BOOT, assert_same_state, boot,
                          configs, corpus, port_engine, port_raw, ref_engine,
                          streams)
from repro.core.gus import FeatureStore as JFeatureStore
from repro_torch import convert
from repro_torch.core.gus import FeatureStore
from test_torch_gus import _assert_same_neighbors
from test_torch_multimodal import _assert_same_result


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


def _host_only(obj, where="state"):
    """Every array in a snapshot is numpy (no tensor, on any device)."""
    assert not isinstance(obj, torch.Tensor), where
    if isinstance(obj, dict):
        for k, v in obj.items():
            _host_only(v, f"{where}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _host_only(v, f"{where}[{i}]")


def test_feature_store_len_contains_snapshot_round_trip(world):
    """``len`` / ``in`` and the snapshot round trip, beside the
    reference's store on the same rows: the same ids and features."""
    ids, feats = world
    t, j = FeatureStore(DATA.spec), FeatureStore(DATA.spec)
    js = JFeatureStore(J_DATA.spec)
    for store in (t, js):
        store.put(ids[:40], boot(feats, 40))
        store.drop(ids[5:9])
    assert len(t) == len(js) == 36
    assert int(ids[0]) in t and int(ids[6]) not in t
    assert (ids[0] in t) == (ids[0] in js)
    snap = t.snapshot_state()
    _host_only(snap)
    ref = js.snapshot_state()
    np.testing.assert_array_equal(snap["ids"], ref["ids"])
    for k in ref["features"]:
        np.testing.assert_array_equal(snap["features"][k],
                                      ref["features"][k])
    j.put(ids[100:104], boot(feats, 104))      # rows the restore drops
    j.restore_state(snap)
    assert len(j) == 36 and int(ids[100]) not in j
    np.testing.assert_array_equal(j.ids(), t.ids())
    empty = FeatureStore(DATA.spec)
    empty.restore_state({"ids": np.zeros(0, np.int64), "features": {}})
    assert len(empty) == 0


@pytest.mark.parametrize("plane", ["plain", "graph", "multimodal"])
def test_snapshot_restore_matches_reference(world, plane):
    """Both packages' engines at one state, two mutation batches, then a
    snapshot each. Restored: the reference's into a fresh reference
    engine; the port's into a fresh port engine; and
    ``convert.engine_snapshot`` of the reference's into another. The
    port's restores answer as the reference's does; the one from the
    reference's snapshot serves the reference's graph rows bit for bit;
    the port's snapshot holds host arrays only."""
    ids, feats = world
    jcfg, tcfg = configs("brute", graph=plane == "graph",
                         multimodal=plane == "multimodal", idf_size=10_000,
                         filter_percent=5.0)
    jg = ref_engine(jcfg, ids, feats)
    tg = port_engine(tcfg, ids, feats, jg)
    jstream, tstream = streams(3)
    for _, jb, tb in zip(range(2), jstream, tstream):
        jg.mutate(jb)
        tg.mutate(tb)
    jsnap, tsnap = jg.snapshot_state(), tg.snapshot_state()
    _host_only(tsnap)
    assert tsnap["index"] == {}
    np.testing.assert_array_equal(tsnap["store"]["ids"],
                                  jsnap["store"]["ids"])

    j_rest = ref_engine(jcfg, ids, feats, bootstrap=False)
    j_rest.restore_state(jsnap)
    t_own = port_raw(tcfg, jg)
    t_own.restore_state(tsnap)
    t_ref = port_raw(tcfg, jg)
    conv = convert.engine_snapshot(jsnap)
    _host_only(conv)
    t_ref.restore_state(conv)
    # the port's restore reproduces the engine it snapshotted
    assert set(t_own.store.ids().tolist()) == set(tg.store.ids().tolist())
    if plane == "graph":
        np.testing.assert_array_equal(t_own.graph.nbr_slots.numpy(),
                                      tg.graph.nbr_slots.numpy())
        np.testing.assert_array_equal(t_own.graph.nbr_w.numpy(),
                                      tg.graph.nbr_w.numpy())
        assert t_own.graph.components() == tg.graph.components()

    qids = np.asarray(sorted(jg.store._rows))[10:26]
    q = {k: v[N_BOOT + 100:N_BOOT + 116] for k, v in feats.items()}
    if plane == "multimodal":
        assert len(t_ref.multimodal) == len(j_rest.multimodal)
        assert t_ref.multimodal.reloads == j_rest.multimodal.reloads
        for t in (t_own, t_ref):
            _assert_same_result(j_rest.neighbors(q, k=5),
                                t.neighbors(q, k=5), unit=False)
            _assert_same_result(j_rest.neighbors_of_ids(qids, k=5),
                                t.neighbors_of_ids(qids, k=5), unit=False)
        return
    for t in (t_own, t_ref):
        _assert_same_neighbors(j_rest._index_neighbors_of_ids(qids, 5),
                               t._index_neighbors_of_ids(qids, 5), 5)
        _assert_same_neighbors(j_rest.neighbors(q, k=5),
                               t.neighbors(q, k=5), 5)
    if plane == "graph":
        # the reference's graph rows, restored into the port, serve as
        # the reference's restored engine serves them
        want = j_rest.neighbors_of_ids(qids, k=4)
        got = t_ref.neighbors_of_ids(qids, k=4)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.weights, want.weights)
        assert t_ref.graph.slot_of == j_rest.graph.slot_of


def test_periodic_reload_matches_reference(world):
    """After two mutation batches both packages recompute IDF/filter from
    the live corpus (IDF-S 10,000, Filter-P 5) and reload the brute index:
    the same tables (ids bitwise, weights within 1e-6) and answers."""
    ids, feats = world
    jcfg, tcfg = configs("brute", idf_size=10_000, filter_percent=5.0)
    jg = ref_engine(jcfg, ids, feats)
    tg = port_engine(tcfg, ids, feats, jg)
    jstream, tstream = streams(4, insert_frac=0.5, update_frac=0.3)
    for _, jb, tb in zip(range(2), jstream, tstream):
        jg.mutate(jb)
        tg.mutate(tb)
    before = tg.embedder.idf.sorted_ids.clone()
    jg.periodic_reload()
    tg.periodic_reload()
    assert not torch.equal(before, tg.embedder.idf.sorted_ids)
    np.testing.assert_array_equal(tg.embedder.idf.sorted_ids.numpy(),
                                  np.asarray(jg.embedder.idf.sorted_ids))
    np.testing.assert_allclose(tg.embedder.idf.weights.numpy(),
                               np.asarray(jg.embedder.idf.weights),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tg.embedder.filter.sorted_ids.numpy(),
                                  np.asarray(jg.embedder.filter.sorted_ids))
    assert len(tg.index) == len(jg.index)
    qids = np.asarray(sorted(jg.store._rows))[:16]
    _assert_same_neighbors(jg.neighbors_of_ids(qids, k=5),
                           tg.neighbors_of_ids(qids, k=5), 5)


def test_multimodal_periodic_reload_rebuilds_the_plane(world):
    """``periodic_reload`` re-seeds the multi-modal plane over the live
    corpus, as the reference's does: the same points and reload count."""
    ids, feats = world
    jcfg, tcfg = configs("brute", multimodal=True)
    jg = ref_engine(jcfg, ids, feats)
    tg = port_engine(tcfg, ids, feats, jg)
    jstream, tstream = streams(6)
    jb, tb = next(iter(jstream)), next(iter(tstream))
    jg.mutate(jb)
    tg.mutate(tb)
    jg.periodic_reload()
    tg.periodic_reload()
    assert len(tg.multimodal) == len(jg.multimodal) == len(tg.store)
    assert tg.multimodal.reloads == jg.multimodal.reloads
    q = {k: v[N_BOOT + 50:N_BOOT + 66] for k, v in feats.items()}
    _assert_same_result(jg.neighbors(q, k=5), tg.neighbors(q, k=5),
                        unit=False)


def test_scann_restore_repeats(world):
    """A scann restore retrains partitions and codebooks (torch-seeded):
    two restores of one snapshot give the same engine bit for bit, graph
    included, and both keep serving the snapshotted corpus."""
    ids, feats = world
    _, tcfg = configs("scann", graph=True)
    tg = port_engine(tcfg, ids, feats)
    for _, tb in zip(range(2), streams(8)[1]):
        tg.mutate(tb)
    snap = tg.snapshot_state()
    a, b = port_raw(tcfg), port_raw(tcfg)
    a.restore_state(snap)
    b.restore_state(snap)
    assert_same_state(a, b)
    assert set(a.store.ids().tolist()) == set(tg.store.ids().tolist())
    np.testing.assert_array_equal(a.graph.nbr_slots.numpy(),
                                  tg.graph.nbr_slots.numpy())
    qids = tg.store.ids()[:8]
    np.testing.assert_array_equal(a.neighbors_of_ids(qids, k=4).ids,
                                  tg.neighbors_of_ids(qids, k=4).ids)
