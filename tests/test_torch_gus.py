"""The port's slice as a whole against the reference: ``DynamicGUS`` with
the scann (and brute) backend on one numpy stream, the reference's trained
state carried across with ``repro_torch.convert``; the port's own
torch-seeded bootstrap judged by quality; and the port's guards (no jax /
``repro`` import, the card as the default device)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann.scann import ScannConfig as JScannConfig
from repro.core import BucketConfig as JBucketConfig
from repro.core import DynamicGUS as JDynamicGUS
from repro.core import GusConfig as JGusConfig
from repro.data.stream import MutationStream as JStream
from repro.data.stream import StreamConfig as JStreamConfig
from repro.data.synthetic import OGB_ARXIV_LIKE as J_ARXIV
from repro_torch import convert
from repro_torch.ann.brute import BruteIndex
from repro_torch.ann.scann import ScannConfig, ScannIndex
from repro_torch.ann.sharded_index import ShardedConfig, ShardedGusIndex
from repro_torch.configs import reduced_config
from repro_torch.core import BucketConfig, FeatureSpec
from repro_torch.core.buckets import make_bucket_params
from repro_torch.core.embedding import EmbeddingGenerator
from repro_torch.core.gus import DynamicGUS, GusConfig
from repro_torch.core.idf import build_filter_table, build_idf_table
from repro_torch.core.scorer import (pair_feature_dim, pair_features,
                                     scorer_init, train_scorer)
from repro_torch.data.stream import MutationStream, StreamConfig
from repro_torch.data.synthetic import (OGB_ARXIV_LIKE, labeled_pairs,
                                        make_dataset)
from repro_torch.launch import train as train_cli
from repro_torch.models import encdec, hybrid, ssm, xlstm
from repro_torch.models.transformer import init_cache as lm_init_cache
from repro_torch.models.transformer import init_params as lm_init_params
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state

ROOT = Path(__file__).resolve().parent.parent
DATA = dataclasses.replace(OGB_ARXIV_LIKE, n_points=1500, n_clusters=15)
J_DATA = dataclasses.replace(J_ARXIV, n_points=1500, n_clusters=15)
BUCKETS = dict(dense_tables=8, dense_bits=10, scalar_widths=(2.0,))
SCANN = dict(d_proj=64, n_partitions=16, nprobe=10, reorder=128)
# the parity tests carry the reference's trained state across, so its
# training need not converge: few iterations keep its eager loops short
TRAIN_FAST = dict(kmeans_iters=3, pq_iters=2)
LM_CFG = reduced_config("qwen3-8b")
MOE_CFG = reduced_config("qwen2-moe-a2.7b")
XLSTM_CFG = reduced_config("xlstm-1.3b")
ENCDEC_CFG = reduced_config("whisper-tiny")
HYBRID_CFG = reduced_config("jamba-1.5-large-398b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    one machine, and torch's default of one thread per core oversubscribes
    it against the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reference_state(jg) -> dict:
    """The reference engine's trained state as numpy (convert.py's format)."""
    emb = jg.embedder
    state = {
        "bucket_params": {k: np.asarray(v) for k, v in emb.params.items()},
        "idf": {"sorted_ids": np.asarray(emb.idf.sorted_ids),
                "weights": np.asarray(emb.idf.weights),
                "default_weight": np.asarray(emb.idf.default_weight)},
        "filter": {"sorted_ids": np.asarray(emb.filter.sorted_ids)},
        "scorer": {k: np.asarray(v) for k, v in jg.scorer_params.items()},
    }
    if jg.cfg.backend == "scann":
        state.update(centroids=np.asarray(jg.index.centroids),
                     books=np.asarray(jg.index.books),
                     capacity=jg.index.capacity, slab=jg.index.slab)
    elif jg.cfg.backend == "sharded":
        state.update(centroids=np.asarray(jg.index.state["centroids"]),
                     books=np.asarray(jg.index.state["books"]),
                     slab=jg.index.slab, salt=jg.index.salt)
    return state


def _scorer_arrays(seed: int = 0) -> dict:
    """He-normal scorer weights from numpy, the same for both engines."""
    rng = np.random.default_rng(seed)
    dims = [pair_feature_dim(DATA.spec), 10, 10, 1]
    out = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = (rng.normal(size=(d_in, d_out))
                        * (2.0 / d_in) ** 0.5).astype(np.float32)
        out[f"b{i}"] = np.zeros((d_out,), np.float32)
    return out


def _pair(backend: str, idf_size: int = 0, filter_percent: float = 0.0,
          graph: tuple = (None, None)):
    """A reference engine and a port engine bootstrapped to one state;
    ``graph`` holds the two packages' GraphConfig (None: no graph)."""
    jstream = JStream(J_DATA, JStreamConfig(batch_size=15, seed=5), 0.6)
    tstream = MutationStream(DATA, StreamConfig(batch_size=15, seed=5), 0.6)
    scorer = _scorer_arrays()
    kw = dict(scann_nn=10, idf_size=idf_size, filter_percent=filter_percent,
              backend=backend)
    jg = JDynamicGUS(J_DATA.spec, JBucketConfig(**BUCKETS),
                     {k: jnp.asarray(v) for k, v in scorer.items()},
                     JGusConfig(scann=JScannConfig(**SCANN, **TRAIN_FAST),
                                graph=graph[0], **kw))
    jg.bootstrap(*jstream.bootstrap())
    tg = DynamicGUS(DATA.spec, BucketConfig(**BUCKETS),
                    convert.scorer_params(scorer, "cpu"),
                    GusConfig(scann=ScannConfig(**SCANN, **TRAIN_FAST),
                              graph=graph[1], **kw),
                    device="cpu")
    convert.load_bootstrapped(tg, _reference_state(jg), *tstream.bootstrap())
    return jg, tg, jstream, tstream


def _assert_same_neighbors(want, got, k):
    """Distances equal within atol 1e-5 row by row (plus rtol 1e-6, the
    sparse_dot tolerance: IDF-weighted sums are taken in another order);
    ids equal except inside a group of equal distance that reaches the cut
    at k (a near-tie at the cut); weights equal within 1e-5 wherever the
    ids agree. Returns the number of positions whose ids differ."""
    np.testing.assert_allclose(got.distances, want.distances, atol=1e-5,
                               rtol=1e-6)
    diff = 0
    for r in range(want.ids.shape[0]):
        d = want.distances[r]
        cut = d[k - 1]
        below = d < cut - (1e-5 + 1e-6 * abs(cut))
        assert (set(want.ids[r][below].tolist())
                == set(got.ids[r][below].tolist())), (r, want.ids[r], got.ids[r])
        diff += int((want.ids[r] != got.ids[r]).sum())
    same = want.ids == got.ids
    np.testing.assert_allclose(got.weights[same], want.weights[same],
                               atol=1e-5, rtol=0)
    return diff


@pytest.mark.parametrize("backend,idf_size,filter_percent",
                         [("scann", 0, 0.0), ("scann", 10_000, 5.0),
                          ("brute", 10_000, 5.0)])
def test_slice_matches_reference(backend, idf_size, filter_percent):
    """Bootstrap, a mutation batch (10 inserts, 2 updates, 3 deletes),
    then both neighborhood RPCs: the port answers as the reference does.
    The reference compiles per shape: one batch, which upserts 12 points,
    as many as a query batch holds."""
    jg, tg, jstream, tstream = _pair(backend, idf_size, filter_percent)
    assert len(tg.index) == len(jg.index)
    if backend == "scann":
        assert tg.index.slot_of == jg.index.slot_of     # slot + slab layout
    diffs = 0
    total = 0
    for _, jb, tb in zip(range(1), jstream, tstream):
        np.testing.assert_array_equal(jb.ids, tb.ids)
        assert jg.mutate(jb) == tg.mutate(tb)
        assert len(tg.index) == len(jg.index)
        qids = jstream.query_ids(12)
        np.testing.assert_array_equal(qids, tstream.query_ids(12))
        diffs += _assert_same_neighbors(jg.neighbors_of_ids(qids, k=10),
                                        tg.neighbors_of_ids(qids, k=10), 10)
        # new-point queries (same shapes: the reference compiles one search)
        q = jstream.query_features(12)
        np.testing.assert_array_equal(q["dense:text"],
                                      tstream.query_features(12)["dense:text"])
        diffs += _assert_same_neighbors(jg.neighbors(q, k=10),
                                        tg.neighbors(q, k=10), 10)
        total += 12 * 10 * 2
    if backend == "scann":
        assert tg.index.slot_of == jg.index.slot_of
    # ids differ only at near-ties at a cut: a small share of positions
    assert diffs <= 0.05 * total, (diffs, total)


def test_port_bootstrap_quality():
    """The port's own torch-seeded training (k-means, codebooks, scorer):
    the scorer's loss falls and neighborhoods stay within their cluster
    (the bar of tests/test_system.py::test_neighborhood_quality)."""
    ids, feats, cluster = make_dataset(DATA)
    pf, lbl = labeled_pairs(feats, cluster, 3000, DATA.spec, seed=1)
    scorer, losses = train_scorer(0, DATA.spec, pf, lbl, steps=60,
                                  device="cpu")
    assert losses[-1] < losses[0] * 0.8
    gus = DynamicGUS(DATA.spec, BucketConfig(**BUCKETS), scorer,
                     GusConfig(scann=ScannConfig(**SCANN)), device="cpu")
    gus.bootstrap(ids, feats)
    res = gus.neighbors_of_ids(ids[:40], k=5)
    same = [cluster[n] == cluster[q] for r, q in enumerate(ids[:40])
            for n in res.ids[r] if n >= 0]
    assert np.mean(same) > 0.8
    assert np.isfinite(res.weights[res.ids >= 0]).all()


def test_card_is_the_default_device():
    """``device=None`` means the card; without one every entry point raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    spec = FeatureSpec(dense={"text": 8}, scalars=("year",))
    feats = {"dense:text": np.ones((4, 8), np.float32),
             "scalar:year": np.zeros((4,), np.float32)}
    bid, valid = np.zeros((4, 9), np.int64), np.ones((4, 9), bool)
    entry_points = [
        lambda: DynamicGUS(spec, BucketConfig(), {}, GusConfig()),
        lambda: train_scorer(0, spec, np.zeros((8, 5), np.float32),
                             np.zeros((8,), np.float32), steps=1),
        lambda: scorer_init(0, spec),
        lambda: pair_features(feats, feats, spec),
        lambda: ScannIndex(9, ScannConfig()),
        lambda: ScannIndex.from_trained(9, ScannConfig(), np.zeros((64, 64)),
                                        np.zeros((8, 256, 8))),
        lambda: BruteIndex(9),
        lambda: ShardedGusIndex(9, ShardedConfig(n_shards=2)),
        lambda: ShardedGusIndex.from_trained(9, ShardedConfig(),
                                             np.zeros((16, 64)),
                                             np.zeros((8, 256, 8)), slab=64),
        lambda: EmbeddingGenerator.create(spec, BucketConfig()),
        lambda: make_bucket_params(spec, BucketConfig()),
        lambda: build_idf_table(bid, valid, 4, 10),
        lambda: build_filter_table(bid, valid, 5.0),
        lambda: convert.scorer_params({"w0": np.zeros((5, 10))}),
        lambda: lm_init_params(0, LM_CFG),
        lambda: lm_init_cache(LM_CFG, 1, 4),
        lambda: convert.lm_params({"embed": np.zeros((4, 2))}, LM_CFG),
        lambda: lm_init_params(0, MOE_CFG),
        lambda: lm_init_cache(MOE_CFG, 1, 4),
        lambda: xlstm.init_params(0, XLSTM_CFG),
        lambda: xlstm.init_cache(XLSTM_CFG, 1, 4),
        lambda: encdec.init_params(0, ENCDEC_CFG),
        lambda: encdec.init_cache(ENCDEC_CFG, 1, 4),
        # the encoder's cross K/V go into a cache made on the default device
        lambda: encdec.encode_prefill(None, ENCDEC_CFG, None,
                                      encdec.init_cache(ENCDEC_CFG, 1, 4)),
        lambda: hybrid.init_params(0, HYBRID_CFG),
        lambda: hybrid.init_cache(HYBRID_CFG, 1, 4),
        lambda: ssm.mlstm_cache(XLSTM_CFG, 1),
        lambda: ssm.slstm_cache(XLSTM_CFG, 1),
        lambda: ssm.mamba_cache(HYBRID_CFG, 1),
        lambda: convert.lm_params({}, HYBRID_CFG),
        lambda: convert.adamw_state({}, LM_CFG, AdamWConfig()),
        lambda: init_train_state(0, LM_CFG, AdamWConfig()),
        lambda: train_cli.run(train_cli.parse_args(
            ["--arch", "qwen3-8b", "--reduced", "--steps", "1"])),
    ]
    for call in entry_points:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_unported_paths_raise():
    """Every backend and every scann shortlist configuration is ported
    (the name is kept from when some of them raised):
    ``GusConfig(backend="sharded")`` builds a ``ShardedGusIndex``; an
    unknown backend still raises."""
    for cfg in (ScannConfig(fused=False), ScannConfig(pq_int8=True)):
        assert ScannIndex(9, cfg, device="cpu").cfg == cfg
    gus = DynamicGUS(DATA.spec, BucketConfig(), {},
                     GusConfig(backend="sharded",
                               sharded=ShardedConfig(n_shards=2)),
                     device="cpu")
    assert isinstance(gus.index, ShardedGusIndex)
    assert gus.index.cfg.n_shards == 2 and gus.index.mesh.size == 2
    assert gus.maintenance == gus.index.cfg.maintenance
    with pytest.raises(ValueError, match="unknown GUS backend"):
        DynamicGUS(DATA.spec, BucketConfig(), {},
                   GusConfig(backend="annoy"), device="cpu")


_GUARD = """
import importlib, pkgutil, runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
runpy.run_path(sys.argv[1], run_name="chip_smoke_import_check")
bad = sorted(m for m, mod in list(sys.modules.items()) if mod is not None
             and (m in ("jax", "repro")
                  or m.startswith(("jax.", "jaxlib", "repro."))))
assert not bad, bad
print(" ".join(names))
"""


def test_port_imports_no_jax_and_no_reference():
    """Every module of repro_torch, and chip_smoke.py, imports with jax
    and the reference package blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _GUARD,
                          str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 81
    assert {f"repro_torch.{m}" for m in (
        "graph", "graph.store", "graph.cc", "core.graph", "core.grale",
        "ann.sharded", "ann.sharded_index", "launch.mesh", "launch.dryrun",
        "core.maintenance", "kernels.topk_select", "kernels.pq_score",
        "serve", "serve.engine", "serve.faults", "serve.frontend",
        "serve.maintenance", "serve.pipeline", "serve.replica",
        "serve.serve_step", "launch", "launch.serve", "configs",
        "configs.base", "configs.registry", "configs.qwen3_8b",
        "configs.qwen2_vl_7b", "configs.whisper_tiny", "models",
        "models.layers", "models.transformer", "models.model", "models.moe",
        "models.ssm", "models.xlstm", "models.encdec", "models.hybrid",
        "utils.tree", "train", "train.optimizer", "train.train_step",
        "train.checkpoint", "data.tokens", "launch.train")} <= names
