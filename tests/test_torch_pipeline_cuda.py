"""The write path on the card: pipelined == synchronous bit for bit
(a maintained graph with brute and scann, scann's fused windows), each
barrier the batch's own CUDA event, and no path through ``mutate`` or the
pipeline reaching ``torch.cuda.synchronize``. The world is
``tests/test_torch_pipeline.py``'s, made here without the reference (the
chip machine has no JAX). Run on the H100 with

    python -m pytest -q -m cuda tests/test_torch_pipeline_cuda.py

Without a card every test here skips (the ``card`` fixture decides).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.ann.scann import ScannConfig
from repro_torch.core.buckets import BucketConfig
from repro_torch.core.gus import DynamicGUS, GusConfig
from repro_torch.core.scorer import pair_feature_dim
from repro_torch.data.stream import MutationStream, StreamConfig
from repro_torch.data.synthetic import OGB_ARXIV_LIKE, make_dataset
from repro_torch.graph.store import GraphConfig
from repro_torch.serve.pipeline import MutationPipeline

pytestmark = pytest.mark.cuda

DATA = dataclasses.replace(OGB_ARXIV_LIKE, n_points=300, n_clusters=6)
N_BOOT = 150
_ARRAYS = ("sp_idx", "sp_val", "members", "codes_list", "valid_list")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _engine(backend: str, graph: bool, dev) -> DynamicGUS:
    rng = np.random.default_rng(0)
    dims = [pair_feature_dim(DATA.spec), 10, 10, 1]
    scorer = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        scorer[f"w{i}"] = torch.as_tensor(
            (rng.normal(size=(d_in, d_out)) * (2.0 / d_in) ** 0.5)
            .astype(np.float32))
        scorer[f"b{i}"] = torch.zeros(d_out)
    cfg = GusConfig(scann_nn=5, backend=backend,
                    scann=ScannConfig(d_proj=32, n_partitions=16, nprobe=4,
                                      reorder=64),
                    graph=GraphConfig(k=4, capacity=512) if graph else None)
    gus = DynamicGUS(DATA.spec, BucketConfig(dense_tables=8, dense_bits=10,
                                             scalar_widths=(2.0,)),
                     scorer, cfg, device=dev)
    ids, feats, _ = make_dataset(DATA)
    gus.bootstrap(ids[:N_BOOT], {k: v[:N_BOOT] for k, v in feats.items()})
    return gus


def _stream(seed, **kw):
    return MutationStream(DATA, StreamConfig(batch_size=16, seed=seed, **kw),
                          0.5)


def _assert_same(a, b):
    assert a.index.slot_of == b.index.slot_of
    names = (("db_idx", "db_val", "valid") if a.cfg.backend == "brute"
             else _ARRAYS)
    for n in names:
        assert torch.equal(getattr(a.index, n), getattr(b.index, n)), n
    qids = a.store.ids()[:24]
    r1 = a._index_neighbors_of_ids(qids, 5)
    r2 = b._index_neighbors_of_ids(qids, 5)
    for f in ("ids", "weights", "distances"):
        np.testing.assert_array_equal(getattr(r1, f), getattr(r2, f))
    if a.graph is not None:
        assert torch.equal(a.graph.nbr_slots, b.graph.nbr_slots)
        assert torch.equal(a.graph.nbr_w, b.graph.nbr_w)
        assert a.graph.components() == b.graph.components()


@pytest.mark.parametrize("backend,graph", [("brute", True), ("scann", True),
                                           ("scann", False)])
def test_pipeline_on_the_card_matches_sync(card, monkeypatch, backend,
                                           graph):
    sync_g, pipe_g = (_engine(backend, graph, card) for _ in range(2))
    first = next(iter(_stream(19)))
    staged = pipe_g.encode_mutation(first)
    pipe_g.apply_mutation(staged)
    assert isinstance(staged.pending, torch.cuda.Event)
    pipe_g.finish_mutation(staged)
    assert staged.pending.query()             # the writes are done
    pipe_g.seq_applied += 1
    pipe_g.graph_apply(staged)
    pipe_g.flush_graph_repair()
    sync_g.mutate(first)

    def refuse(*args, **kwargs):
        raise AssertionError("the write path synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    pipe = MutationPipeline(pipe_g)
    # without a graph, insert-only batches: the windows fuse
    kw = {} if graph else dict(insert_frac=1.0, update_frac=0.0)
    for _, a, b in zip(range(6), _stream(5, **kw), _stream(5, **kw)):
        sync_g.mutate(a)
        pipe.submit(b)
    pipe.flush()
    if not graph:
        assert pipe.windows < pipe.submitted // 16
    monkeypatch.undo()
    _assert_same(sync_g, pipe_g)
