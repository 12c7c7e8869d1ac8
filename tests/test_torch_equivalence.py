"""The paper's two quality claims on the port, on the CPU.

Lemma 4.1: a point's neighborhood is exactly Grale's if the index returns
every point with negative distance — {q : Dist(p,q) < 0} == {q : p,q
share a bucket ID} == Grale's scoring pairs (``tests/test_lemma41.py``'s
three tests, here on the port's own torch-seeded buckets, and the same
set from ``ScannIndex.search_threshold`` when the shortlist holds every
copy).

§5.1: the offline and the dynamic index give identical results, and a
rebuild keeps the exact top-k (``tests/test_dynamic_equivalence.py``'s
ScannIndex tests, on the port's own torch-seeded build: judged by the
property, not by bits). Against the reference: ``rebuild``'s slot map
(slot assignment does not depend on the trained centroids, so it must
equal the reference's exactly), and ``search_threshold`` on indexes built
``from_trained`` from the reference's centroids and codebooks (trained on
the port's embedding of the corpus) and fed the same rows: the same ids
per row, in the same order up to a group of equal distance, and the
distances bit for bit. With unit values that holds at the reference
test's shortlist (reorder 256); with IDF-like values the LUT's float
order moves near-ties at the shortlist cut (one id of 24 rows there), so
that case takes every copy into the shortlist.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypo_compat import given, settings, st

from repro.ann.scann import ScannConfig as JScannConfig
from repro.ann.scann import ScannIndex as JScannIndex
from repro.core.types import SparseBatch as JSparseBatch
from repro_torch.ann import BruteIndex, ScannConfig, ScannIndex
from repro_torch.core import BucketConfig
from repro_torch.core.embedding import EmbeddingGenerator
from repro_torch.core.grale import GraleConfig, scoring_pairs
from repro_torch.core.types import SparseBatch, sort_sparse
from repro_torch.data.synthetic import OGB_ARXIV_LIKE, make_dataset

EQUIV = dict(d_proj=64, n_partitions=16, nprobe=16, reorder=256)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    one machine, and torch's default of one thread per core oversubscribes
    it against the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ Lemma 4.1

@pytest.fixture(scope="module")
def lemma_corpus():
    cfg = dataclasses.replace(OGB_ARXIV_LIKE, n_points=400, n_clusters=12)
    ids, feats, _ = make_dataset(cfg)
    gen = EmbeddingGenerator.create(
        cfg.spec, BucketConfig(dense_tables=6, dense_bits=8,
                               scalar_widths=(2.0,)), device="cpu")
    bid, valid = gen.buckets(feats)
    return ids, gen(feats), gen.k_max, bid.numpy(), valid.numpy()


def _threshold_index(kind: str, k_max: int, ids, emb):
    """The exact index, or a quantized one probing every partition with a
    shortlist of every copy (so its approximation drops nothing)."""
    if kind == "brute":
        index = BruteIndex(k_max, device="cpu")
        index.upsert(ids, emb)
    else:
        index = ScannIndex(k_max, ScannConfig(
            d_proj=32, n_partitions=8, nprobe=8, reorder=1024),
            device="cpu")
        index.build(ids, emb)
    return index


@pytest.mark.parametrize("kind", ["brute", "scann"])
def test_negative_distance_iff_shared_bucket(lemma_corpus, kind):
    ids, emb, k_max, bid, valid = lemma_corpus
    index = _threshold_index(kind, k_max, ids, emb)
    results = index.search_threshold(emb[:60], tau=0.0)
    bucket_sets = [set(bid[i][valid[i]].tolist()) for i in range(len(ids))]
    for i, (got_ids, dists) in enumerate(results):
        expect = {int(j) for j in range(len(ids))
                  if bucket_sets[i] & bucket_sets[j]}
        assert set(got_ids.tolist()) == expect, f"query {i}"
        assert (dists < 0).all()


@pytest.mark.parametrize("kind", ["brute", "scann"])
def test_equals_grale_scoring_pairs(lemma_corpus, kind):
    """End-to-end edge-set equality with the Grale baseline (Fig. 3)."""
    ids, emb, k_max, bid, valid = lemma_corpus
    pairs = scoring_pairs(bid, valid, GraleConfig(bucket_split=None))
    grale_edges = {tuple(p) for p in pairs.tolist()}
    index = _threshold_index(kind, k_max, ids, emb)
    gus_edges = set()
    for i, (got_ids, _) in enumerate(index.search_threshold(emb, tau=0.0)):
        for j in got_ids.tolist():
            if i != j:
                gus_edges.add((min(i, j), max(i, j)))
    assert gus_edges == grale_edges


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_lemma_on_random_bucket_assignments(data):
    """Property form: random bucket IDs, exact equality must still hold."""
    n = data.draw(st.integers(4, 24))
    k = data.draw(st.integers(1, 5))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    bid = rng.integers(0, 10, size=(n, k))
    valid = rng.random((n, k)) < 0.9
    vals = np.where(valid, 1.0, 0.0).astype(np.float32)
    emb = sort_sparse(torch.as_tensor(bid), torch.as_tensor(vals))

    index = BruteIndex(k, device="cpu")
    index.upsert(np.arange(n), emb)
    results = index.search_threshold(emb, tau=0.0)
    bucket_sets = [set(bid[i][valid[i]].tolist()) for i in range(n)]
    for i, (got_ids, _) in enumerate(results):
        expect = {j for j in range(n) if bucket_sets[i] & bucket_sets[j]}
        assert set(got_ids.tolist()) == expect


# ------------------------------------------- ScannIndex lifecycle (port)

@pytest.fixture(scope="module")
def corpus():
    data = dataclasses.replace(OGB_ARXIV_LIKE, n_points=900, n_clusters=12)
    ids, feats, _ = make_dataset(data)
    gen = EmbeddingGenerator.create(
        data.spec, BucketConfig(dense_tables=8, dense_bits=10,
                                scalar_widths=(2.0,)), device="cpu")
    return ids, gen(feats), gen


def test_scann_offline_vs_dynamic(corpus):
    """Same offline-trained structures (paper §4.3): bulk build vs an empty
    ``from_trained`` index fed purely through the mutation path return
    identical exact-rescored top-k distances."""
    ids, emb, gen = corpus
    cfg = ScannConfig(**EQUIV)
    offline = ScannIndex(gen.k_max, cfg, device="cpu")
    offline.build(ids, emb)
    dynamic = ScannIndex.from_trained(
        gen.k_max, cfg, offline.centroids, offline.books,
        capacity=len(ids) * 2, device="cpu")
    order = np.random.default_rng(1).permutation(len(ids))
    for lo in range(0, len(ids), 63):            # odd-sized random batches
        sel = torch.as_tensor(order[lo:lo + 63])
        dynamic.upsert(ids[sel.numpy()], emb[sel])
    _, d_off = offline.search(emb[:24], 6)
    _, d_dyn = dynamic.search(emb[:24], 6)
    np.testing.assert_allclose(np.sort(d_off, -1), np.sort(d_dyn, -1),
                               atol=1e-5)


def test_scann_delete_reinsert_reuses_slots(corpus):
    """upsert -> delete -> reinsert recycles both the global slot and the
    per-partition slab positions (no storage leak), and restores identical
    search results."""
    ids, emb, gen = corpus
    idx = ScannIndex(gen.k_max, ScannConfig(**EQUIV), device="cpu")
    idx.build(ids, emb)
    cap_before, slab_before = idx.capacity, idx.slab
    free_before = len(idx.free_slots)
    recs = {int(p): idx.slot_of[int(p)] for p in ids[:100].tolist()}
    _, d_before = idx.search(emb[:16], 6)

    idx.delete(ids[:100])
    assert len(idx.free_slots) == free_before + 100
    idx.upsert(ids[:100], emb[:100])
    assert len(idx.free_slots) == free_before
    assert idx.capacity == cap_before and idx.slab == slab_before
    assert {idx.slot_of[p][0] for p in recs} == {r[0] for r in recs.values()}
    _, d_after = idx.search(emb[:16], 6)
    np.testing.assert_allclose(np.sort(d_before, -1), np.sort(d_after, -1),
                               atol=1e-5)


def test_scann_rebuild_preserves_search_results(corpus):
    """rebuild() retrains partitions and codebooks from the live points;
    with exhaustive probing the exact-rescored top-k is unchanged, the
    tombstones are gone and no slab entry of the old layout survives."""
    ids, emb, gen = corpus
    idx = ScannIndex(gen.k_max, ScannConfig(**dict(EQUIV, reorder=512)),
                     device="cpu")
    idx.build(ids, emb)
    idx.delete(ids[:50])                     # rebuild must drop tombstones
    _, d_before = idx.search(emb[:16], 6)
    n_live = len(idx)
    idx.rebuild()
    assert len(idx) == n_live
    assert all(ids[i] not in idx.slot_of for i in range(50))
    assert int(idx.valid_list.sum()) == 2 * n_live
    assert sorted(idx.free_slots) == list(range(n_live, idx.capacity))
    _, d_after = idx.search(emb[:16], 6)
    np.testing.assert_allclose(np.sort(d_before, -1), np.sort(d_after, -1),
                               atol=1e-5)


def test_scann_soar_copy_consistency(corpus):
    """Every point carries a primary and a SOAR secondary copy in distinct
    partitions, both registered in the slabs; disabling SOAR drops to one
    copy."""
    ids, emb, gen = corpus
    cfg = ScannConfig(**EQUIV)
    idx = ScannIndex(gen.k_max, cfg, device="cpu")
    idx.build(ids, emb)
    members = idx.members.numpy()
    valid = idx.valid_list.numpy()
    for pid in ids[:200].tolist():
        rec = idx.slot_of[pid]
        slot, copies = rec[0], rec[1:]
        assert len(copies) == 2
        assert copies[0][0] != copies[1][0]          # distinct partitions
        for p, pos in copies:
            assert members[p, pos] == slot
            assert valid[p, pos]
    assert int(valid.sum()) == 2 * len(idx)

    no_soar = ScannIndex(gen.k_max, dataclasses.replace(cfg, soar_lambda=-1.0),
                         device="cpu")
    no_soar.build(ids, emb)
    assert all(len(no_soar.slot_of[p][1:]) == 1 for p in ids[:50].tolist())
    assert int(no_soar.valid_list.sum()) == len(no_soar)


# --------------------------------------------------- against the reference

def _both(idx: np.ndarray, val: np.ndarray, rows=slice(None)):
    """The same rows as the reference's and the port's SparseBatch."""
    return (JSparseBatch(jnp.asarray(idx[rows].astype(np.uint32)),
                         jnp.asarray(val[rows])),
            SparseBatch(torch.tensor(idx[rows]), torch.tensor(val[rows])))


@pytest.fixture(scope="module")
def reference(corpus):
    """The port's corpus embedding (unit values) as numpy, and a reference
    index built on the same rows (its centroids and codebooks)."""
    ids, emb, gen = corpus
    idx, val = emb.indices.numpy(), emb.values.numpy()
    index = JScannIndex(gen.k_max, JScannConfig(**EQUIV))
    index.build(ids, _both(idx, val)[0])
    return dict(ids=ids, k=gen.k_max, index=index, idx=idx, val=val)


def test_rebuild_slot_map_matches_reference(reference):
    """Delete 50 points and insert them again (they move to the end of the
    insertion order, in recycled slots), then rebuild both indexes: the
    live ids, their order and their slots equal the reference's, and the
    old layout's free slots are gone."""
    ids, index = reference["ids"], reference["index"]
    jemb, temb = _both(reference["idx"], reference["val"])
    port = ScannIndex(reference["k"], ScannConfig(**EQUIV), device="cpu")
    port.build(ids, temb)
    for target, emb in ((index, jemb), (port, temb)):
        target.delete(ids[:50])
        target.upsert(ids[:50], emb[:50])
    assert ({p: r[0] for p, r in port.slot_of.items()}
            == {p: r[0] for p, r in index.slot_of.items()})
    index.rebuild()
    port.rebuild()
    assert list(port.slot_of) == list(index.slot_of)
    assert ([r[0] for r in port.slot_of.values()]
            == [r[0] for r in index.slot_of.values()])
    assert port.free_slots == index.free_slots
    np.testing.assert_array_equal(port.ids, index.ids)


def _idf_like(idx: np.ndarray, val: np.ndarray) -> np.ndarray:
    """One seeded weight in [0.2, 1.2) per bucket id, as an IDF table
    gives."""
    uniq, inv = np.unique(idx, return_inverse=True)
    weight = (0.2 + np.random.default_rng(1).random(len(uniq))
              ).astype(np.float32)
    return np.where(val != 0, weight[inv.reshape(idx.shape)],
                    0.0).astype(np.float32)


@pytest.mark.parametrize("values,reorder", [("unit", 256), ("idf", 2048)])
def test_search_threshold_matches_reference(reference, values, reorder):
    """Indexes ``from_trained`` on the reference's centroids and codebooks,
    fed the same rows in batches of 50: per row the same ids in the same
    order up to groups of equal distance, the distances bit for bit."""
    ids, index = reference["ids"], reference["index"]
    idx = reference["idx"]
    val = reference["val"] if values == "unit" else _idf_like(
        idx, reference["val"])
    cfg = dict(EQUIV, reorder=reorder)
    jd = JScannIndex.from_trained(reference["k"], JScannConfig(**cfg),
                                  index.centroids, index.books,
                                  capacity=1800)
    td = ScannIndex.from_trained(reference["k"], ScannConfig(**cfg),
                                 np.asarray(index.centroids),
                                 np.asarray(index.books), capacity=1800,
                                 device="cpu")
    for lo in range(0, len(ids), 50):            # the slot-map test's shape
        jemb, temb = _both(idx, val, slice(lo, lo + 50))
        jd.upsert(ids[lo:lo + 50], jemb)
        td.upsert(ids[lo:lo + 50], temb)
    jq, tq = _both(idx, val, slice(0, 24))
    want = jd.search_threshold(jq, 0.0)
    got = td.search_threshold(tq, 0.0)
    assert sum(len(w) for w, _ in want) > 24 * 30
    for r, ((w_ids, w_d), (g_ids, g_d)) in enumerate(zip(want, got)):
        assert len(g_ids) == len(w_ids), r
        np.testing.assert_array_equal(g_d.view(np.int32), w_d.view(np.int32))
        for d in np.unique(w_d):
            assert (sorted(g_ids[g_d == d].tolist())
                    == sorted(w_ids[w_d == d].tolist())), (r, d)
        assert (g_d < 0).all()
