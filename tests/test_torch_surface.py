"""The rest of the JAX package's public surface on the port, on the CPU.

* The backend contract (``ann.MutableAnnBackend``, ``ann.StagedAnnBackend``,
  ``core.maintenance.SnapshotStateful``): ``tests/test_backend_protocol.
  py``'s conformance tests over the port's three backends and
  ``IdfCounts``, at that file's sizes.
* The helpers against the reference: the exact sparse dots (bitwise with
  unit values, rtol 1e-6 with IDF-like ones: the port sums in the
  shared-db kernel's order), ``lut_scores`` (rtol 1e-6), ``quantized_
  partition_sizes`` (equal), ``scorer_logits`` (rtol 1e-6: products in
  another order), ``FeatureSpec.validate`` (the same keys pass, the same
  message), ``SparseBatch.nnz`` (equal) and ``DynamicGraphStore.restore``
  (the reference's restored store, field for field).
* Every public name of ``repro.{core,data,utils,ann}`` and every name
  this slice added is reachable from the port with ``jax`` and ``repro``
  blocked, and importing ``repro_torch.core`` initialises no CUDA.
"""
import dataclasses
import importlib
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import partition as jpart
from repro.ann import quantize as jpq
from repro.ann import sparse as jsparse
from repro.core import scorer as jscorer
from repro.core.types import NeighborResult as JNeighborResult
from repro.core.types import SparseBatch as JSparseBatch
from repro.core.types import sort_sparse as j_sort_sparse
from repro.data.synthetic import OGB_ARXIV_LIKE as J_ARXIV
from repro.graph.store import DynamicGraphStore as JStore
from repro.graph.store import GraphConfig as JGraphConfig
from repro_torch import convert
from repro_torch.ann import (BruteIndex, MutableAnnBackend, ScannConfig,
                             ScannIndex, ShardedConfig, ShardedGusIndex,
                             StagedAnnBackend)
from repro_torch.ann import partition as tpart
from repro_torch.ann import quantize as tpq
from repro_torch.ann import sparse as tsparse
from repro_torch.core import BucketConfig
from repro_torch.core import scorer as tscorer
from repro_torch.core.embedding import EmbeddingGenerator
from repro_torch.core.maintenance import SnapshotStateful
from repro_torch.core.types import SparseBatch, sort_sparse
from repro_torch.data.synthetic import OGB_ARXIV_LIKE, make_dataset
from repro_torch.graph.store import DynamicGraphStore

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ["brute", "scann", "sharded"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    one machine, and torch's default of one thread per core oversubscribes
    it against the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------ the backend contract

@pytest.fixture(scope="module")
def corpus():
    data = dataclasses.replace(OGB_ARXIV_LIKE, n_points=400, n_clusters=8)
    ids, feats, _ = make_dataset(data)
    gen = EmbeddingGenerator.create(
        data.spec, BucketConfig(dense_tables=8, dense_bits=10,
                                scalar_widths=(2.0,)), device="cpu")
    return ids, gen(feats)


def make_backend(name: str, k: int):
    if name == "brute":
        return BruteIndex(k, device="cpu")
    if name == "scann":
        return ScannIndex(k, ScannConfig(d_proj=32, n_partitions=8,
                                         nprobe=4, reorder=64), device="cpu")
    return ShardedGusIndex(k, ShardedConfig(
        n_shards=1, d_proj=32, n_partitions=8, nprobe_local=0, reorder=512,
        pq_m=4, kmeans_iters=4, pq_iters=2), device="cpu")


@pytest.mark.parametrize("name", BACKENDS)
def test_structural_conformance(corpus, name):
    """Every backend satisfies all three runtime-checkable protocols."""
    _, emb = corpus
    idx = make_backend(name, emb.k)
    assert isinstance(idx, MutableAnnBackend)
    assert isinstance(idx, StagedAnnBackend)
    assert isinstance(idx, SnapshotStateful)


@pytest.mark.parametrize("name", BACKENDS)
def test_mutable_backend_contract(corpus, name):
    """build -> upsert -> search -> delete behaves alike (up to
    approximation) across backends: inserted points become their own
    nearest neighbor, deletes are idempotent and make rows invisible."""
    ids, emb = corpus
    idx = make_backend(name, emb.k)
    idx.build(ids[:200], emb[:200])
    assert len(idx) == 200
    idx.upsert(ids[200:220], emb[200:220])
    assert len(idx) == 220
    got, dists = idx.search(emb[200:201], 3)
    assert got.shape == (1, 3) and dists.shape == (1, 3)
    assert got[0, 0] == ids[200]
    assert dists[0, 0] < 0                       # negative-dot distance
    assert idx.delete(ids[200:205]) == 5
    assert idx.delete(ids[200:205]) == 0         # idempotent
    assert len(idx) == 215
    got, _ = idx.search(emb[200:201], 5)
    assert int(ids[200]) not in set(got[got >= 0].tolist())


@pytest.mark.parametrize("name", BACKENDS)
def test_staged_backend_composition(corpus, name):
    """The three-phase split composes to exactly ``upsert``."""
    ids, emb = corpus
    idx = make_backend(name, emb.k)
    idx.build(ids[:200], emb[:200])
    staged = idx.encode_upsert(ids[220:230], emb[220:230])
    pending = idx.begin_upsert(ids[220:230], emb[220:230], staged)
    idx.finish_upsert(pending)
    assert len(idx) == 210
    got, _ = idx.search(emb[221:222], 1)
    assert got[0, 0] == ids[221]


@pytest.mark.parametrize("name", BACKENDS)
def test_snapshot_state_round_trip(corpus, name):
    """snapshot_state() -> restore_state() onto a fresh instance carries
    the routing policy (the sharded owner-hash salt), so a rebuild from
    the same corpus searches the same way."""
    ids, emb = corpus
    idx = make_backend(name, emb.k)
    idx.build(ids[:200], emb[:200])
    state = idx.snapshot_state()
    assert isinstance(state, dict)
    fresh = make_backend(name, emb.k)
    fresh.restore_state(state)               # install policy BEFORE build
    if hasattr(idx, "salt"):
        assert fresh.salt == idx.salt
    fresh.build(ids[:200], emb[:200])
    i1, d1 = idx.search(emb[:16], 5)
    i2, d2 = fresh.search(emb[:16], 5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


def test_idf_counts_structural_conformance():
    from repro_torch.core.idf import IdfCounts
    from repro_torch.multimodal import MultiModalConfig, MultiModalStore
    assert isinstance(IdfCounts(), SnapshotStateful)
    assert isinstance(MultiModalStore(MultiModalConfig(), device="cpu"),
                      SnapshotStateful)


# ------------------------------------------- helpers against the reference

def _sparse_rows(seed: int, n: int, k: int, unit: bool):
    """Rows over a vocabulary of 12 (many matches), 10% padding; unit or
    IDF-like values. -> (reference SparseBatch, port SparseBatch)."""
    rng = np.random.default_rng(seed)
    bid = rng.integers(0, 12, (n, k))
    val = np.where(rng.random((n, k)) < 0.9,
                   1.0 if unit else 0.2 + rng.random((n, k)),
                   0.0).astype(np.float32)
    return (j_sort_sparse(jnp.asarray(bid.astype(np.uint32)),
                          jnp.asarray(val)),
            sort_sparse(torch.as_tensor(bid), torch.as_tensor(val)))


def _assert_close(got: torch.Tensor, want, unit: bool):
    want = np.asarray(want)
    if unit:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("unit", [True, False])
def test_sparse_dots_match_reference(unit):
    """``sparse_dot_pair`` / ``_one_many`` / ``_many_many``: 7 query rows
    of K = 6 against 40 rows of K = 9."""
    jq, tq = _sparse_rows(0, 7, 6, unit)
    jdb, tdb = _sparse_rows(1, 40, 9, unit)
    want = jsparse.sparse_dot_many_many(jq, jdb)
    got = tsparse.sparse_dot_many_many(tq, tdb)
    assert got.shape == (7, 40) and got.dtype == torch.float32
    _assert_close(got, want, unit)
    assert (np.asarray(want) > 0).mean() > 0.5       # matches to sum
    for r in (0, 3):
        _assert_close(tsparse.sparse_dot_one_many(
            tq.indices[r], tq.values[r], tdb.indices, tdb.values),
            jsparse.sparse_dot_one_many(jq.indices[r], jq.values[r],
                                        jdb.indices, jdb.values), unit)
        for c in (0, 5, 39):
            _assert_close(tsparse.sparse_dot_pair(
                tq.indices[r], tq.values[r], tdb.indices[c],
                tdb.values[c]), jsparse.sparse_dot_pair(
                jq.indices[r], jq.values[r], jdb.indices[c],
                jdb.values[c]), unit)


def test_lut_scores_and_partition_sizes_match_reference():
    rng = np.random.default_rng(2)
    lut = rng.normal(size=(8, 16)).astype(np.float32)
    codes = rng.integers(0, 16, (50, 8)).astype(np.uint8)
    np.testing.assert_allclose(
        tpq.lut_scores(torch.as_tensor(lut), torch.as_tensor(codes)).numpy(),
        np.asarray(jpq.lut_scores(jnp.asarray(lut), jnp.asarray(codes))),
        rtol=1e-6, atol=0)
    p1 = rng.integers(0, 12, 300)
    p2 = rng.integers(0, 12, 300)
    got = tpart.quantized_partition_sizes(p1, p2, 16)
    np.testing.assert_array_equal(got,
                                  jpart.quantized_partition_sizes(p1, p2, 16))
    assert got.sum() == 600 and (got[12:] == 0).all()


def test_scorer_logits_match_reference():
    spec = OGB_ARXIV_LIKE.spec
    f = tscorer.pair_feature_dim(spec)
    assert f == jscorer.pair_feature_dim(J_ARXIV.spec)
    rng = np.random.default_rng(4)
    params = {}
    for i, (d_in, d_out) in enumerate([(f, 10), (10, 10), (10, 1)]):
        params[f"w{i}"] = rng.normal(size=(d_in, d_out)).astype(np.float32)
        params[f"b{i}"] = rng.normal(size=(d_out,)).astype(np.float32)
    feats = rng.normal(size=(33, f)).astype(np.float32)
    tparams = convert.scorer_params(params, "cpu")
    got = tscorer.scorer_logits(tparams, torch.as_tensor(feats))  # legacy-ok
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    want = jscorer.scorer_logits(jparams, jnp.asarray(feats))  # legacy-ok
    assert got.shape == (33,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(
        tscorer.scorer_apply(tparams, torch.as_tensor(feats)).numpy(),
        torch.sigmoid(got).numpy())


def test_feature_spec_validate_and_nnz_match_reference():
    spec, jspec = OGB_ARXIV_LIKE.spec, J_ARXIV.spec
    good = {key: None for key in jspec.feature_shapes(1)}
    jspec.validate(good)
    spec.validate(good)
    bad = dict(good, **{"dense:extra": None})
    with pytest.raises(ValueError) as want:
        jspec.validate(bad)
    with pytest.raises(ValueError) as got:
        spec.validate(bad)
    assert str(got.value) == str(want.value)

    jq, tq = _sparse_rows(5, 20, 8, unit=False)
    # zero a few values without padding their index: nnz skips both
    tq.values[:4, 0] = 0.0
    jq = JSparseBatch(jq.indices, jq.values.at[:4, 0].set(0.0))
    np.testing.assert_array_equal(tq.nnz().numpy(), np.asarray(jq.nnz()))
    assert isinstance(SparseBatch(tq.indices[:0], tq.values[:0]).nnz(),
                      torch.Tensor)


def test_graph_store_restore_matches_reference():
    """``restore`` (the ``SnapshotStateful`` spelling) is
    ``restore_state``: the reference's store after two upserts and a
    delete, restored into a fresh store of each package, field for
    field."""
    js = JStore(JGraphConfig(k=3, width=6, capacity=64))
    rng = np.random.default_rng(6)
    for lo in (0, 8):
        ids = np.arange(lo, lo + 8)
        rows = rng.integers(0, lo + 8, (8, 4))
        w = rng.choice(np.asarray([0.25, 0.5, 0.9], np.float32), (8, 4))
        js.upsert(ids, JNeighborResult(ids=rows.astype(np.int64), weights=w,
                                       distances=np.zeros_like(w)))
    js.delete(np.asarray([3, 12]))
    state = js.snapshot_state()
    jr = JStore(JGraphConfig(k=3, width=6, capacity=64))
    jr.restore(state)
    snap = convert.graph_snapshot(state)
    tr = DynamicGraphStore(snap["cfg"], device="cpu")
    tr.restore(snap)
    twin = DynamicGraphStore(snap["cfg"], device="cpu")
    twin.restore_state(snap)
    for store in (tr, twin):
        for name in ("nbr_slots", "nbr_w", "ids_dev", "alive", "labels"):
            np.testing.assert_array_equal(getattr(store, name).numpy(),
                                          np.asarray(getattr(jr, name)))
        np.testing.assert_array_equal(store.id_of_slot, jr.id_of_slot)
        assert store.slot_of == jr.slot_of
        assert store._free == jr._free
        assert sorted(store._repair) == sorted(jr._repair)
    assert tr.components() == jr.components()


# ------------------------------------------------ names, jax blocked

def _public(package: str) -> list:
    """The public names of a reference package (its lazy ones included),
    without submodules and typing helpers."""
    mod = importlib.import_module(f"repro.{package}")
    names = {name for name, value in vars(mod).items()
             if not name.startswith("_") and not inspect.ismodule(value)
             and getattr(value, "__module__", None) != "typing"}
    return sorted(names | set(getattr(mod, "_LAZY", {})))


# the names this slice adds below the package level: module -> attributes
ADDED = {
    "repro_torch.ann.scann": ["ScannIndex.rebuild",
                              "ScannIndex.search_threshold"],
    "repro_torch.ann.sparse": ["sparse_dot_pair", "sparse_dot_one_many",
                               "sparse_dot_many_many"],
    "repro_torch.ann.quantize": ["lut_scores"],
    "repro_torch.ann.partition": ["quantized_partition_sizes"],
    "repro_torch.core.scorer": ["scorer_logits"],
    "repro_torch.core.types": ["FeatureSpec.validate", "SparseBatch.nnz"],
    "repro_torch.core.maintenance": ["SnapshotStateful"],
    "repro_torch.graph.store": ["DynamicGraphStore.restore"],
}

_NAMES = """
import importlib, json, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
calls = []
torch.cuda._lazy_init = lambda: calls.append("init")
importlib.import_module("repro_torch.core")
core = [torch.cuda.is_initialized(), list(calls)]
want = json.loads(sys.argv[1])
missing = []
for module, names in want.items():
    mod = importlib.import_module(module)
    for name in names:
        obj = mod
        try:
            for part in name.split("."):
                obj = getattr(obj, part)
        except AttributeError:
            missing.append(f"{module}:{name}")
print(json.dumps({"missing": missing, "core": core, "calls": calls}))
"""


def test_public_names_reachable_without_jax():
    """Every public name of ``repro.{core,data,utils,ann}`` resolves on
    the port's package of the same name, and so does every name of the
    slice, in a process where ``jax`` and ``repro`` cannot be imported;
    importing ``repro_torch.core`` neither initialises CUDA nor asks to."""
    want = {f"repro_torch.{pkg}": _public(pkg)
            for pkg in ("core", "data", "utils", "ann")}
    assert {"DynamicGUS", "grale_graph", "MutableAnnBackend",
            "make_dataset", "tree_cast"} <= {
        n for names in want.values() for n in names}
    want.update(ADDED)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _NAMES, json.dumps(want)],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["missing"] == []
    assert got["core"] == [False, []] and got["calls"] == []
