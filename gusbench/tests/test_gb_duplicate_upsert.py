"""The program fault that keeps the mutation cells out of the benchmark
(``PERF.md``, Open questions): a mutation batch that upserts one id twice
leaves the first copy's slot live in the index, so the id keeps two rows,
and after the id is deleted its orphan copy is still found. The same ops
sent as two batches leave no orphan, as the reference's replay (the last
upsert of an id wins) expects."""
import numpy as np
import torch

from repro_torch.ann.scann import ScannConfig, ScannIndex
from repro_torch.core.types import SparseBatch


def _emb(rows):
    idx = torch.as_tensor(rows, dtype=torch.int64)
    return SparseBatch(idx, torch.ones(idx.shape, dtype=torch.float32))


def _index():
    rng = np.random.default_rng(0)
    rows = np.sort(rng.choice(5000, size=(300, 9), replace=True), axis=1)
    rows = np.unique(rows, axis=0)[:256]
    ix = ScannIndex(9, ScannConfig(n_partitions=8, nprobe=8, reorder=64,
                                   kmeans_iters=2, pq_iters=2), "cpu")
    ix.build(np.arange(rows.shape[0]), _emb(rows))
    return ix, rows


def _valid_entries_of(ix, pid):
    slots = set(np.nonzero(ix.ids == pid)[0].tolist())
    entries = ix.members[ix.valid_list].numpy().tolist()
    return sum(e in slots for e in entries)


def test_one_batch_upserting_an_id_twice_leaves_an_orphan():
    ix, rows = _index()
    new = np.asarray([[1, 2, 3, 4, 5, 6, 7, 8, 9]])
    ix.upsert(np.asarray([900, 900]), _emb(np.concatenate([new, new + 10])))
    assert len(ix) == rows.shape[0] + 1
    assert _valid_entries_of(ix, 900) == 4          # two copies x SOAR
    ix.delete([900])
    found, _ = ix.search(_emb(new), 5)
    assert 900 in found[0].tolist()                 # a deleted id comes back


def test_the_same_ops_in_two_batches_leave_none():
    ix, _ = _index()
    new = np.asarray([[1, 2, 3, 4, 5, 6, 7, 8, 9]])
    ix.upsert(np.asarray([900]), _emb(new))
    ix.upsert(np.asarray([900]), _emb(new + 10))
    assert _valid_entries_of(ix, 900) == 2
    ix.delete([900])
    found, _ = ix.search(_emb(new), 5)
    assert 900 not in found[0].tolist()
