"""The slice's index methods and sparse dots on the card against the same
calls on the CPU: ``ScannIndex.rebuild`` (the slot map exactly; with every
partition probed, the exact top-k distances before and after within
1e-5), ``ScannIndex.search_threshold`` on indexes ``from_trained`` from one
set of centroids and codebooks with a shortlist of every copy (the same
ids per row, the distances bit for bit) and ``sparse_dot_many_many`` (bit
for bit, through the shared-db kernel). Run on the H100 with

    python -m pytest -q -m cuda tests/test_torch_surface_cuda.py

Without a card every test here skips (the ``card`` fixture decides).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.ann import ScannConfig, ScannIndex
from repro_torch.ann.sparse import sparse_dot_many_many
from repro_torch.core import BucketConfig
from repro_torch.core.embedding import EmbeddingGenerator
from repro_torch.core.types import SparseBatch
from repro_torch.data.synthetic import OGB_ARXIV_LIKE, make_dataset
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda

CFG = ScannConfig(d_proj=64, n_partitions=16, nprobe=16, reorder=512)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _corpus():
    """900 points' embeddings on the CPU (unit values)."""
    data = dataclasses.replace(OGB_ARXIV_LIKE, n_points=900, n_clusters=12)
    ids, feats, _ = make_dataset(data)
    gen = EmbeddingGenerator.create(
        data.spec, BucketConfig(dense_tables=8, dense_bits=10,
                                scalar_widths=(2.0,)), device="cpu")
    return ids, gen(feats), gen.k_max


def _on(emb: SparseBatch, dev) -> SparseBatch:
    return SparseBatch(emb.indices.to(dev), emb.values.to(dev))


def test_rebuild_on_the_card(card):
    ids, emb, k = _corpus()
    runs = {}
    for dev in (torch.device("cpu"), card):
        idx = ScannIndex(k, CFG, device=dev)
        idx.build(ids, _on(emb, dev))
        idx.delete(ids[:50])
        idx.upsert(ids[:10], _on(emb[:10], dev))
        _, before = idx.search(_on(emb[:16], dev), 6)
        ops.reset_launch_counts()
        idx.rebuild()
        _, after = idx.search(_on(emb[:16], dev), 6)
        counts = ops.launch_counts()
        runs[dev.type] = (idx, before, after, counts)
        np.testing.assert_allclose(np.sort(before, -1), np.sort(after, -1),
                                   atol=1e-5)
    cpu, cuda = runs["cpu"][0], runs["cuda"][0]
    assert len(cuda) == len(cpu) == 860
    assert list(cuda.slot_of) == list(cpu.slot_of)
    assert ([r[0] for r in cuda.slot_of.values()]
            == [r[0] for r in cpu.slot_of.values()])
    assert cuda.free_slots == cpu.free_slots
    assert int(cuda.valid_list.sum()) == 2 * len(cuda)
    assert runs["cuda"][3]["fused_query"] >= 1
    assert runs["cuda"][3]["sparse_rescore_topk"] >= 1
    assert not any(runs["cpu"][3].values())        # the plain versions


def test_search_threshold_on_the_card(card):
    ids, emb, k = _corpus()
    trained = ScannIndex(k, CFG, device="cpu")
    trained.build(ids, emb)
    cfg = dataclasses.replace(CFG, reorder=2048)     # >= every copy
    got = {}
    for dev in (torch.device("cpu"), card):
        idx = ScannIndex.from_trained(k, cfg, trained.centroids.numpy(),
                                      trained.books.numpy(), capacity=1800,
                                      device=dev)
        for lo in range(0, len(ids), 300):
            idx.upsert(ids[lo:lo + 300], _on(emb[lo:lo + 300], dev))
        got[dev.type] = idx.search_threshold(_on(emb[:24], dev), 0.0)
    for (c_ids, c_d), (g_ids, g_d) in zip(got["cpu"], got["cuda"]):
        assert len(c_ids) == len(g_ids) > 0
        np.testing.assert_array_equal(g_d.view(np.int32), c_d.view(np.int32))
        for d in np.unique(c_d):
            assert (sorted(g_ids[g_d == d].tolist())
                    == sorted(c_ids[c_d == d].tolist()))


def test_sparse_dot_many_many_on_the_card(card):
    _, emb, _ = _corpus()
    want = sparse_dot_many_many(emb[:64], emb)
    ops.reset_launch_counts()
    got = sparse_dot_many_many(_on(emb[:64], card), _on(emb, card))
    assert ops.launch_counts()["sparse_dot"] == 1
    assert got.shape == (64, 900)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
