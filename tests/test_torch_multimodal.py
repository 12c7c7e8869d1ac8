"""The port's multi-modal scoring plane against the reference's, on one
numpy-seeded world (``tests/test_multimodal.py``'s size: arxiv-like, 260
points, 6 clusters; ``sparse_k=6, d_sketch=32, idf_size=128``), the
reference's hyperplanes and scorer carried across with ``convert``:

* ``IdfCounts`` incremental == rebuild == the reference's, bitwise;
* the store's sparse candidates bitwise after bootstrap, deletes and
  updates, and a reload; its snapshot, and ``convert.multimodal_state``
  of the reference's, restore to the same candidates;
* ``two_stage_neighbors`` through the engine: ids equal but at near-ties
  of the weight order, weights within rtol 1e-5 / atol 1e-6, distances
  bitwise at unit values and within 1e-6 with IDF weights;
* ``GusConfig(multimodal=None)`` serves the dense path bitwise;
* the Android-Security stream equal to the reference's, and the
  harmful-app mechanism on the port alone.

The reference's Pallas kernels run in interpret mode, as its own tests run
them on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BucketConfig as JBucketConfig
from repro.core import DynamicGUS as JDynamicGUS
from repro.core import GusConfig as JGusConfig
from repro.core import MutationBatch as JMutationBatch
from repro.core import idf as jidf
from repro.core.scorer import train_scorer as j_train_scorer
from repro.data import synthetic as jsyn
from repro.multimodal import MultiModalConfig as JMultiModalConfig
from repro_torch import convert
from repro_torch.core import idf as tidf
from repro_torch.core.buckets import BucketConfig
from repro_torch.core.gus import DynamicGUS, GusConfig
from repro_torch.core.scorer import score_pairs, train_scorer
from repro_torch.core.types import (MUTATION_DELETE, MUTATION_INSERT,
                                    MUTATION_UPDATE, MutationBatch)
from repro_torch.data import synthetic as tsyn
from repro_torch.multimodal import MultiModalConfig, MultiModalStore

J_DATA = dataclasses.replace(jsyn.OGB_ARXIV_LIKE, n_points=260, n_clusters=6)
DATA = dataclasses.replace(tsyn.OGB_ARXIV_LIKE, n_points=260, n_clusters=6)
BUCKETS = dict(dense_tables=8, dense_bits=10, scalar_widths=(2.0,))
MM = dict(sparse_k=6, d_sketch=32, idf_size=128, filter_percent=1.0)
N_BOOT = 180


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world():
    """The corpus (both packages' generators agree on it), the reference's
    scorer, and a reference and a port engine per configuration, built
    once: "unit" (no engine IDF: unit embedding values) and "idf"."""
    ids, feats, cluster = jsyn.make_dataset(J_DATA)
    t_ids, t_feats, t_cluster = tsyn.make_dataset(DATA)
    np.testing.assert_array_equal(ids, t_ids)
    for key in feats:
        np.testing.assert_array_equal(feats[key], t_feats[key])
    pf, lbl = jsyn.labeled_pairs(feats, cluster, 600, J_DATA.spec, seed=1)
    scorer, _ = j_train_scorer(jax.random.PRNGKey(0), J_DATA.spec, pf, lbl,
                               steps=40)
    scorer = {k: np.asarray(v) for k, v in scorer.items()}
    engines = {name: _pair(ids, feats, scorer, idf_size)
               for name, idf_size in (("unit", 0), ("idf", 10_000))}
    return ids, feats, scorer, engines


def _pair(ids, feats, scorer, idf_size: int, reload_every: int = 2):
    jg = JDynamicGUS(J_DATA.spec, JBucketConfig(**BUCKETS),
                     {k: jnp.asarray(v) for k, v in scorer.items()},
                     JGusConfig(scann_nn=5, backend="brute",
                                idf_size=idf_size, multimodal=(
                                    JMultiModalConfig(
                                        **MM, reload_every=reload_every))))
    boot = {k: v[:N_BOOT] for k, v in feats.items()}
    jg.bootstrap(ids[:N_BOOT], boot)
    tg = DynamicGUS(DATA.spec, BucketConfig(**BUCKETS),
                    convert.scorer_params(scorer, "cpu"),
                    GusConfig(scann_nn=5, backend="brute", idf_size=idf_size,
                              multimodal=MultiModalConfig(
                                  **MM, reload_every=reload_every)),
                    device="cpu")
    emb = jg.embedder
    state = {
        "bucket_params": {k: np.asarray(v) for k, v in emb.params.items()},
        "idf": {"sorted_ids": np.asarray(emb.idf.sorted_ids),
                "weights": np.asarray(emb.idf.weights),
                "default_weight": np.asarray(emb.idf.default_weight)},
        "filter": {"sorted_ids": np.asarray(emb.filter.sorted_ids)},
        "scorer": scorer}
    convert.load_bootstrapped(tg, state, ids[:N_BOOT], boot)
    return jg, tg


def _batches(ids, feats, seed: int, n: int = 2):
    """Mixed batches (inserts of unseen points, updates with other
    points' features, deletes), for both packages' types."""
    rng = np.random.default_rng(seed)
    fresh = list(range(N_BOOT, len(ids)))
    out = []
    for _ in range(n):
        ins = [fresh.pop(0) for _ in range(8)]
        upd = rng.choice(N_BOOT, 3, replace=False).tolist()
        dele = rng.choice(N_BOOT, 2, replace=False).tolist()
        rows = ins + rng.choice(len(ids), 3).tolist() + [0, 0]
        pids = np.asarray(ins + upd + dele, np.int64)
        kinds = np.asarray([MUTATION_INSERT] * 8 + [MUTATION_UPDATE] * 3
                           + [MUTATION_DELETE] * 2, np.int32)
        f = {k: v[rows] for k, v in feats.items()}
        out.append((JMutationBatch(kinds=kinds, ids=pids, features=f),
                    MutationBatch(kinds=kinds, ids=pids, features=f)))
    return out


def _candidates(gus, q, torch_side: bool):
    """The store's sparse candidates for query features ``q``."""
    emb = gus.embedder(q)
    b_ids, b_valid = gus.embedder.buckets(q)
    if torch_side:
        b_ids, b_valid = b_ids.numpy(), b_valid.numpy()
    return gus.multimodal.candidates(np.asarray(b_ids), np.asarray(b_valid),
                                     emb)


# -------------------------------------------------------------- IdfCounts

def test_idf_counts_incremental_equals_rebuild_and_reference():
    """Interleaved adds and removes (duplicates within rows, masked cells)
    leave tables bitwise equal to a from-scratch build over the corpus
    left, and to the reference's IdfCounts fed the same batches; the
    snapshot round-trips."""
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 60, (90, 7)).astype(np.uint32)
    valid = rng.random((90, 7)) < 0.8
    tc, jc = tidf.IdfCounts(), jidf.IdfCounts()
    live = []
    for step in range(12):
        lo = step * 7
        tc.add(rows[lo:lo + 7], valid[lo:lo + 7])
        jc.add(rows[lo:lo + 7], valid[lo:lo + 7])
        live += list(range(lo, lo + 7))
        if step % 3 == 2:
            gone = live[1::4]
            live = [i for i in live if i not in gone]
            tc.remove(rows[gone], valid[gone])
            jc.remove(rows[gone], valid[gone])
    for got, want in zip(tc.arrays(), jc.arrays()):
        np.testing.assert_array_equal(got, want)
    assert tc.n_points == jc.n_points == len(live)
    for size in (16, 1000):
        t, j = tc.idf_table(size, "cpu"), jc.idf_table(size)
        scratch = tidf.build_idf_table(rows[live], valid[live], len(live),
                                       size, "cpu")
        for a, b in ((t, scratch), (t, j)):
            np.testing.assert_array_equal(a.sorted_ids.numpy(),
                                          np.asarray(b.sorted_ids))
            np.testing.assert_array_equal(
                a.weights.numpy().view(np.int32),
                np.asarray(b.weights).view(np.int32))
            assert float(a.default_weight) == float(b.default_weight)
    for pct in (1.0, 20.0):
        t, j = tc.filter_table(pct, "cpu"), jc.filter_table(pct)
        scratch = tidf.build_filter_table(rows[live], valid[live], pct, "cpu")
        np.testing.assert_array_equal(t.sorted_ids.numpy(),
                                      scratch.sorted_ids.numpy())
        np.testing.assert_array_equal(t.sorted_ids.numpy(),
                                      np.asarray(j.sorted_ids))
    back = tidf.IdfCounts()
    back.restore_state(tc.snapshot_state())
    assert back.arrays()[0].tolist() == tc.arrays()[0].tolist()
    assert back.n_points == tc.n_points


# ------------------------------------------------------ sparse candidates

def test_candidates_match_reference_through_the_stream(world):
    """The port's store answers ``candidates`` bitwise as the reference's
    after bootstrap, after each batch of inserts, updates and deletes,
    and across the reloads of its cadence (every 2 batches); the store's
    counts, postings and tables agree too."""
    ids, feats, _, engines = world
    jg, tg = engines["unit"]
    q = {k: v[100:124] for k, v in feats.items()}
    np.testing.assert_array_equal(_candidates(tg, q, True),
                                  _candidates(jg, q, False))
    for jb, tb in _batches(ids, feats, seed=5):
        jg.mutate(jb)
        tg.mutate(tb)
        got, want = _candidates(tg, q, True), _candidates(jg, q, False)
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).any()
    a, b = tg.multimodal, jg.multimodal
    assert a.reloads == b.reloads == 2          # bootstrap's + one cadence
    assert a._postings == b._postings
    for x, y in zip(a.counts.arrays(), b.counts.arrays()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.idf.sorted_ids.numpy(),
                                  np.asarray(b.idf.sorted_ids))
    np.testing.assert_array_equal(a.filter.sorted_ids.numpy(),
                                  np.asarray(b.filter.sorted_ids))
    for pid in b._sketch:
        np.testing.assert_array_equal(a._sketch[pid], b._sketch[pid])
    assert a.describe() == b.describe()
    snap_t, snap_j = a.obs.registry.snapshot(), b.obs.registry.snapshot()
    assert set(snap_t) == set(snap_j)
    for name, row in snap_j.items():          # timings aside
        if row["type"] != "histogram":
            assert snap_t[name] == row, name


def test_snapshot_and_reference_snapshot_restore(world):
    """A port store restored from the port's snapshot, and one restored
    from ``convert.multimodal_state`` of the reference's snapshot, answer
    ``candidates`` as the snapshotted stores do."""
    _, feats, _, engines = world
    jg, tg = engines["idf"]
    q = {k: v[200:224] for k, v in feats.items()}
    want = _candidates(jg, q, False)
    cfg = MultiModalConfig(**MM)
    own = MultiModalStore(cfg, device="cpu")
    own.restore_state(tg.multimodal.snapshot_state())
    ref = MultiModalStore(cfg, device="cpu")
    ref.restore_state(convert.multimodal_state(
        jg.multimodal.snapshot_state()))
    b_ids, b_valid = (t.numpy() for t in tg.embedder.buckets(q))
    emb = tg.embedder(q)
    for store in (tg.multimodal, own, ref):
        np.testing.assert_array_equal(store.candidates(b_ids, b_valid, emb),
                                      want)
    assert own.reloads == ref.reloads == jg.multimodal.reloads
    assert len(own) == len(ref) == len(jg.multimodal)


# ------------------------------------------------ two-stage neighborhoods

def _assert_same_result(want, got, unit: bool) -> None:
    """Weights within rtol 1e-5 / atol 1e-6 position by position (both
    sorted descending); ids equal except where the reference's weight
    ties its neighbour's within that tolerance (a near-tie of the order);
    distances of equal ids bitwise with unit values, else within 1e-6."""
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-5,
                               atol=1e-6)
    w = want.weights
    diff = want.ids != got.ids
    for r, c in zip(*np.nonzero(diff)):
        near = [abs(w[r, c] - w[r, cc]) <= 1e-6 + 1e-5 * abs(w[r, c])
                for cc in (c - 1, c + 1) if 0 <= cc < w.shape[1]]
        assert any(near), (r, c, want.ids[r], got.ids[r], w[r])
    assert diff.sum() <= 0.05 * diff.size
    same = ~diff
    if unit:
        np.testing.assert_array_equal(got.distances[same].view(np.int32),
                                      want.distances[same].view(np.int32))
    else:
        np.testing.assert_allclose(got.distances[same], want.distances[same],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("values", ["unit", "idf"])
def test_two_stage_neighbors_match_reference(world, values):
    """New-point queries and existing-id queries (self excluded) through
    both engines' two-stage path."""
    ids, feats, _, engines = world
    jg, tg = engines[values]
    q = {k: v[230:246] for k, v in feats.items()}
    _assert_same_result(jg.neighbors(q, k=5), tg.neighbors(q, k=5),
                        values == "unit")
    qids = ids[20:36]
    _assert_same_result(jg.neighbors_of_ids(qids, k=5),
                        tg.neighbors_of_ids(qids, k=5), values == "unit")
    assert tg.multimodal.describe()["rescored_pairs"] > 0
    assert tg.multimodal.obs.registry.get(
        "multimodal_rescore_ms").count >= 2


def test_default_config_is_bitwise_dense_path(world):
    """``GusConfig()`` without ``multimodal=`` serves the dense path the
    port had before the plane: embed -> index.search -> gather ->
    score_pairs, bitwise."""
    ids, feats, scorer, _ = world
    gus = DynamicGUS(DATA.spec, BucketConfig(**BUCKETS),
                     convert.scorer_params(scorer, "cpu"),
                     GusConfig(scann_nn=5, backend="brute"), device="cpu")
    gus.bootstrap(ids[:N_BOOT], {k: v[:N_BOOT] for k, v in feats.items()})
    assert gus.multimodal is None
    q = {k: v[200:216] for k, v in feats.items()}
    got = gus.neighbors(q, k=5)
    nids, dists = gus.index.search(gus.embedder(q), 5)
    cand = gus.store.gather(nids)
    flat_c = {k: v.reshape((-1,) + v.shape[2:]) for k, v in cand.items()}
    w = score_pairs(gus.scorer_params, q, flat_c, gus.spec,
                    group=nids.shape[1]).numpy()
    w = np.where(nids >= 0, w.reshape(nids.shape), -np.inf)
    np.testing.assert_array_equal(got.ids, nids)
    np.testing.assert_array_equal(got.weights, w.astype(np.float32))
    np.testing.assert_array_equal(got.distances, dists)


# ------------------------------------------------------ Android Security

def test_android_stream_matches_reference():
    """Bootstrap corpus, every batch, the harmful ids and their arrival
    batches are equal; the training pairs' labels are equal and their
    features agree within 1e-6 (norms reduced in another order)."""
    cfg_j, cfg_t = jsyn.AndroidSecurityConfig(), tsyn.AndroidSecurityConfig()
    js, ts = jsyn.AndroidSecurityStream(cfg_j), tsyn.AndroidSecurityStream(
        cfg_t)
    (jb_ids, jb_f), (tb_ids, tb_f) = js.bootstrap(), ts.bootstrap()
    np.testing.assert_array_equal(jb_ids, tb_ids)
    for key in jb_f:
        np.testing.assert_array_equal(jb_f[key], tb_f[key])
    for jb, tb in zip(js.batches(), ts.batches(), strict=True):
        np.testing.assert_array_equal(jb.ids, tb.ids)
        np.testing.assert_array_equal(jb.kinds, tb.kinds)
        for key in jb.features:
            np.testing.assert_array_equal(jb.features[key],
                                          tb.features[key])
    assert js.harmful_ids == ts.harmful_ids
    assert js.arrival_batch == ts.arrival_batch
    assert js.seed_bad_ids == ts.seed_bad_ids
    assert js.family_of == ts.family_of
    (jf, jl), (tf, tl) = js.training_pairs(400), ts.training_pairs(400)
    np.testing.assert_array_equal(jl, tl)
    np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=1e-6)


def test_harmful_app_routes_to_seed_at_insert():
    """The mechanism behind the time-to-flag speedup, on the port: an app
    arriving with an unconverged dense embedding but its family's
    signature tokens surfaces its family seed in the multi-modal union at
    insert time (port mirror of tests/test_multimodal.py's test)."""
    from benchmarks.torch_time_to_flag import build_gus
    stream = tsyn.AndroidSecurityStream(tsyn.AndroidSecurityConfig(
        n_benign=80, n_benign_clusters=4, n_families=2, apps_per_family=2))
    boot_ids, boot_feats = stream.bootstrap()
    feats, labels = stream.training_pairs(n_pairs=400)
    params, _ = train_scorer(7, stream.spec, feats, labels, steps=120,
                             device="cpu")
    gus = build_gus(stream.spec, params, multimodal=True, device="cpu")
    gus.bootstrap(boot_ids, boot_feats)
    first = next(iter(stream.batches()))
    harmful = [int(i) for i, k in zip(first.ids, first.kinds)
               if k == MUTATION_INSERT and int(i) in stream.harmful_ids]
    assert harmful
    gus.mutate(first)
    res = gus.neighbors_of_ids(np.asarray(harmful), k=8)
    seeds = stream.seed_bad_ids
    for row, pid in enumerate(harmful):
        hit = {int(n) for n in res.ids[row] if int(n) in seeds}
        assert any(stream.family_of[s] == stream.family_of[pid]
                   for s in hit), f"app {pid} found no same-family seed"
