"""The sharded backend on the card: four shards on one card answer as the
same four shards on the CPU, and the sharded write path waits on each
batch's own CUDA event, never on ``torch.cuda.synchronize``. Run on the
H100 with

    python -m pytest -q -m cuda tests/test_torch_sharded_cuda.py

Without a card every test here skips (the ``card`` fixture decides).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.ann.sharded_index import ShardedConfig, ShardedGusIndex
from repro_torch.core.buckets import BucketConfig
from repro_torch.core.embedding import EmbeddingGenerator
from repro_torch.core.gus import DynamicGUS, GusConfig
from repro_torch.core.maintenance import MaintenanceConfig
from repro_torch.core.scorer import pair_feature_dim
from repro_torch.data.stream import MutationStream, StreamConfig
from repro_torch.data.synthetic import OGB_ARXIV_LIKE, make_dataset
from repro_torch.serve.pipeline import MutationPipeline

pytestmark = pytest.mark.cuda

DATA = dataclasses.replace(OGB_ARXIV_LIKE, n_points=600, n_clusters=10)
BUCKETS = BucketConfig(dense_tables=8, dense_bits=10, scalar_widths=(2.0,))
CFG = dict(n_shards=4, d_proj=32, n_partitions=16, nprobe_local=0,
           reorder=4096, pq_m=4, kmeans_iters=4, pq_iters=2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same_up_to_ties(want_ids, want_d, got_ids, got_d):
    """Distances within rtol 1e-6 / atol 1e-6; ids equal except among
    entries of equal distance (their order is the slots', which follow
    the placement)."""
    np.testing.assert_allclose(got_d, want_d, rtol=1e-6, atol=1e-6)
    for r in range(want_ids.shape[0]):
        for d in np.unique(want_d[r]):
            sel = want_d[r] == d
            assert set(want_ids[r][sel]) == set(got_ids[r][sel]), (r, d)


@pytest.mark.parametrize("fused,int8", [(True, False), (False, False),
                                        (True, True)])
def test_four_shards_on_the_card_equal_the_cpu(card, fused, int8):
    """One set of trained structures (from a CPU build) in two indexes,
    four shards on the card and four on the CPU: the same stream (load,
    deletes, updates, a compaction) leaves the same points, and 48
    searches give the same ids (up to ties) and distances."""
    ids, feats, _ = make_dataset(DATA)
    cfg = ShardedConfig(**CFG, fused=fused, pq_int8=int8)
    cpu_gen = EmbeddingGenerator.create(DATA.spec, BUCKETS, "cpu")
    emb = cpu_gen(feats)
    ref = ShardedGusIndex(cpu_gen.k_max, cfg, device="cpu")
    ref.build(ids, emb)
    cen = ref.centroids.numpy()
    books = ref.books.numpy()
    out = []
    for dev in ("cpu", card):
        idx = ShardedGusIndex.from_trained(cpu_gen.k_max, cfg, cen, books,
                                           slab=ref.slab, device=dev)
        assert all(d.type == torch.device(dev).type
                   for d in idx.mesh.devices)
        e = type(emb)(emb.indices.to(dev), emb.values.to(dev))
        idx.upsert(ids[:500], e[:500])
        idx.delete(ids[100:200])
        idx.upsert(ids[150:170], e[500:520])
        idx.compact()
        out.append((set(idx.row_of), idx.search(e[:48], 10)))
    (cpu_pts, (w_ids, w_d)), (card_pts, (g_ids, g_d)) = out
    assert cpu_pts == card_pts
    _same_up_to_ties(w_ids, w_d, g_ids, g_d)


def _scorer():
    rng = np.random.default_rng(0)
    dims = [pair_feature_dim(DATA.spec), 10, 10, 1]
    out = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = torch.as_tensor(
            (rng.normal(size=(d_in, d_out)) * (2.0 / d_in) ** 0.5)
            .astype(np.float32))
        out[f"b{i}"] = torch.zeros(d_out)
    return out


def test_sharded_write_path_never_synchronizes(card, monkeypatch):
    """``mutate`` and the pipeline on a 4-shard engine with tight slabs
    (compactions and slab growth inside ``begin_upsert``) reach no
    ``torch.cuda.synchronize``; each batch's barrier is a CUDA event."""
    ids, feats, _ = make_dataset(DATA)
    cfg = GusConfig(scann_nn=5, backend="sharded", sharded=ShardedConfig(
        **dict(CFG, n_partitions=8, slab=64, reorder=512),
        maintenance=MaintenanceConfig(headroom=1.5)))
    gus = DynamicGUS(DATA.spec, BUCKETS, _scorer(), cfg, device=card)
    gus.bootstrap(ids[:300], {k: v[:300] for k, v in feats.items()})

    def refuse(*args, **kwargs):
        raise AssertionError("the write path synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    stream = MutationStream(DATA, StreamConfig(batch_size=32, seed=3), 0.5)
    staged = gus.encode_mutation(next(iter(stream)))
    gus.apply_mutation(staged)
    assert isinstance(staged.pending["event"], torch.cuda.Event)
    gus.finish_mutation(staged)
    for _, batch in zip(range(6), stream):
        gus.mutate(batch)
    pipe = MutationPipeline(gus)
    for _, batch in zip(range(6), stream):
        pipe.submit(batch)
    pipe.flush()
    assert gus.index.compactions >= 1
    assert gus.index.occupancy()["aged_out"] == 0
