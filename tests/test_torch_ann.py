"""Port of ann/ (partition, quantize, brute) against the reference, on the
CPU, plus the port's own torch-seeded index build judged by recall.

Float32 products run in another summation order than XLA's, so scores
agree within rtol 1e-5 / atol 1e-6 and argmin decisions (partition
assignment, PQ codes) agree except at near-ties, which are counted and
bounded: a disagreement is accepted only where the two best costs of the
reference lie within 1e-4 relative of each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import partition as jpart
from repro.ann import quantize as jpq
from repro.ann.brute import BruteIndex as JBruteIndex
from repro.core.types import SparseBatch as JSparseBatch
from repro_torch.ann import partition as tpart
from repro_torch.ann import quantize as tpq
from repro_torch.ann.brute import BruteIndex
from repro_torch.ann.scann import ScannConfig, ScannIndex
from repro_torch.core import BucketConfig
from repro_torch.core.embedding import EmbeddingGenerator
from repro_torch.core.types import SparseBatch
from repro_torch.data.synthetic import OGB_ARXIV_LIKE, make_dataset

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


def _sketch_like(seed, n, d=64):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32)


def _near_tie_rows(cost: np.ndarray, rel: float = 1e-4) -> np.ndarray:
    """Rows whose two lowest costs are within ``rel`` of each other."""
    two = np.sort(cost, axis=-1)[:, :2]
    return (two[:, 1] - two[:, 0]) <= rel * np.maximum(np.abs(two[:, 0]), 1.0)


def test_partition_scores_and_assignment():
    x = _sketch_like(0, 600)
    cents = _sketch_like(1, 24)
    q = _sketch_like(2, 16)
    np.testing.assert_allclose(
        tpart.partition_scores(torch.as_tensor(q), torch.as_tensor(cents)),
        np.asarray(jpart.partition_scores(q, cents)), rtol=1e-5, atol=1e-6)
    for eta in (1.0, 4.0):
        np.testing.assert_allclose(
            tpart.anisotropic_cost(torch.as_tensor(x), torch.as_tensor(cents),
                                   eta).numpy(),
            np.asarray(jpart.anisotropic_cost(x, cents, eta)),
            rtol=1e-5, atol=1e-4)
        jp1, jp2 = map(np.asarray, jpart.assign_partitions(x, cents, eta, 1.0))
        tp1, tp2 = (t.numpy() for t in tpart.assign_partitions(
            torch.as_tensor(x), torch.as_tensor(cents), eta, 1.0))
        ties = _near_tie_rows(np.asarray(jpart.anisotropic_cost(x, cents, eta)))
        bad1 = (jp1 != tp1) & ~ties
        assert not bad1.any(), np.nonzero(bad1)
        # secondaries are compared where the primaries agree
        same = jp1 == tp1
        assert (jp2[same] != tp2[same]).mean() <= 0.01
        assert (tp1 != tp2).all()                     # SOAR copy differs


def test_query_lut_and_encode():
    x = _sketch_like(3, 500)
    q = _sketch_like(4, 12)
    books = _sketch_like(5, 8 * 64, 8).reshape(8, 64, 8)
    np.testing.assert_allclose(
        tpq.query_lut(torch.as_tensor(q), torch.as_tensor(books)).numpy(),
        np.asarray(jpq.query_lut(q, books)), rtol=1e-5, atol=1e-6)
    want = np.asarray(jpq.encode(x, books))
    got = tpq.encode(torch.as_tensor(x), torch.as_tensor(books)).numpy()
    sub = x.reshape(len(x), 8, -1)
    d2 = ((sub[:, :, None, :] - books[None]) ** 2).sum(-1)       # [N, M, C]
    ties = _near_tie_rows(d2.reshape(-1, d2.shape[-1])).reshape(want.shape)
    assert not ((want != got) & ~ties).any()
    assert (want != got).mean() <= 0.01


def test_port_codebooks_and_kmeans_train():
    """The port's own training (torch-seeded): k-means lowers the cost it
    starts from, and the codebooks reconstruct dot products well."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(500, 32)).astype(np.float32))
    q = torch.as_tensor(rng.normal(size=(3, 32)).astype(np.float32))
    books = tpq.train_codebooks(x, m=8, n_centers=64, iters=6, eta=4.0)
    approx = torch.stack([torch.gather(tpq.query_lut(q, books)[i], 1,
                                       tpq.encode(x, books).long().T).sum(0)
                          for i in range(3)])
    c = np.corrcoef((q @ x.T).numpy().ravel(), approx.numpy().ravel())[0, 1]
    assert c > 0.85
    cents = tpart.kmeans(x, 8, iters=8)
    init = x[tpart.sample_rows(500, 8, 0, "cpu")]
    assert (tpart.anisotropic_cost(x, cents, 1.0).min(-1).values.mean()
            < tpart.anisotropic_cost(x, init, 1.0).min(-1).values.mean())


@pytest.fixture(scope="module")
def corpus():
    data = dataclasses.replace(OGB_ARXIV_LIKE, n_points=1200, n_clusters=15)
    ids, feats, _ = make_dataset(data)
    gen = EmbeddingGenerator.create(
        data.spec, BucketConfig(dense_tables=8, dense_bits=10,
                                scalar_widths=(2.0,)), "cpu")
    return ids, gen(feats)


def test_brute_matches_reference(corpus):
    ids, emb = corpus
    jemb = JSparseBatch(jnp.asarray(emb.indices.numpy().astype(np.uint32)),
                        jnp.asarray(emb.values.numpy()))
    jb, tb = JBruteIndex(emb.k), BruteIndex(emb.k, device="cpu")
    for ix, e in ((jb, jemb), (tb, emb)):
        ix.upsert(ids[:700], e[:700])
        ix.delete(ids[:40])
        ix.upsert(ids[100:120], e[900:920])          # updates
    for want, got in zip(jb.search(jemb[:30], 8), tb.search(emb[:30], 8)):
        np.testing.assert_array_equal(got, want)


def test_scann_tie_aware_recall(corpus):
    """The port's own build (torch-seeded k-means and codebooks) against the
    exact index, as tests/test_ann.py::test_scann_tie_aware_recall."""
    ids, emb = corpus
    brute = BruteIndex(emb.k, device="cpu")
    brute.upsert(ids, emb)
    scann = ScannIndex(emb.k, ScannConfig(
        d_proj=64, n_partitions=16, pq_subspaces=8, nprobe=12, reorder=256), device="cpu")
    scann.build(ids, emb)
    bids, bd = brute.search(emb[:60], 6)
    sids, sd = scann.search(emb[:60], 6)
    ok = tot = 0
    for r in range(60):
        kth = bd[r][bids[r] >= 0][:6].max()
        got = sd[r][sids[r] >= 0]
        tot += min(6, (bd[r] < 0).sum())
        ok += ((got <= kth) & (got < 0)).sum()
    assert ok / max(tot, 1) > 0.9
    # dynamic: an inserted point finds itself, a deleted one is gone
    probe = SparseBatch(emb.indices[:1], emb.values[:1])
    scann.delete([0])
    assert 0 not in set(scann.search(probe, 5)[0][0].tolist())
    scann.upsert(ids[:1], probe)
    assert scann.search(probe, 5)[0][0, 0] == 0
