"""Port of core/ (hashing, buckets, IDF tables, embeddings) and ann/sparse
against the reference, on the CPU. Integer and selection work is bitwise:
the hashes (with uint32 wraparound), bucket IDs given the reference's
hyperplanes, ``sort_sparse``, ``embed_batch`` and ``count_sketch``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann.sparse import count_sketch as j_count_sketch
from repro.core import hashing as jh
from repro.core.buckets import BucketConfig as JBucketConfig
from repro.core.embedding import EmbeddingGenerator as JEmbeddingGenerator
from repro.core.idf import build_filter_table as j_build_filter_table
from repro.core.idf import FilterTable as JFilterTable
from repro.core.idf import IdfTable as JIdfTable
from repro.core.idf import build_idf_table as j_build_idf_table
from repro.core.types import sort_sparse as j_sort_sparse
from repro.data.synthetic import OGB_ARXIV_LIKE as J_ARXIV
from repro.data.synthetic import OGB_PRODUCTS_LIKE as J_PRODUCTS
from repro.data.synthetic import make_dataset as j_make_dataset
from repro_torch.ann.sparse import count_sketch
from repro_torch.core import hashing as th
from repro_torch.core.buckets import BucketConfig
from repro_torch.core.embedding import EmbeddingGenerator
from repro_torch.core.idf import build_filter_table, build_idf_table
from repro_torch.core.types import PAD_INDEX, sort_sparse
from repro_torch.data.synthetic import (OGB_ARXIV_LIKE, OGB_PRODUCTS_LIKE,
                                        make_dataset)

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


def _u32_words(seed: int, n: int = 2000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    # wraparound edges: 0, the top bit, all ones, the multiplier wrap
    x[:6] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]
    return x


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(x.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_hashing_bitwise(seed):
    x = _u32_words(seed)
    y = _u32_words(seed + 10)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    pairs = [
        (jh.fmix32(jx), th.fmix32(_t(x))),
        (jh.combine(jx, jy), th.combine(_t(x), _t(y))),
        (jh.hash_fields(jnp.uint32(0xDEADBEEF), jnp.uint32(3), jx),
         th.hash_fields(0xDEADBEEF, 3, _t(x))),
        (jh.uhash(12345 + seed, jx), th.uhash(12345 + seed, _t(x))),
        # int32 inputs wrap to uint32 (PAD_ITEM = -1 -> 0xFFFFFFFF)
        (jh.uhash(7, jnp.asarray(x.view(np.int32))),
         th.uhash(7, torch.as_tensor(x.view(np.int32)))),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                      got.numpy())
    # scalar seeds and Python ints hash identically too
    assert int(jh.fmix32(jnp.uint32(0x9E3779B9))) == th.fmix32(0x9E3779B9)


def _generators(data_j, data_t, **bucket_kw):
    """Reference + port generators sharing hyperplanes drawn with numpy."""
    rng = np.random.default_rng(0)
    cfg = BucketConfig(**bucket_kw)
    planes = {f"hyperplanes:{name}": rng.normal(size=(
        cfg.dense_tables, dim, cfg.dense_bits)).astype(np.float32)
        for name, dim in sorted(data_t.spec.dense.items())}
    jgen = JEmbeddingGenerator(
        data_j.spec, JBucketConfig(**bucket_kw),
        {k: jnp.asarray(v) for k, v in planes.items()},
        JIdfTable.disabled(), JFilterTable.disabled())
    tgen = EmbeddingGenerator.create(data_t.spec, cfg, "cpu")
    tgen.params = {k: torch.as_tensor(v) for k, v in planes.items()}
    return jgen, tgen


CORPORA = {
    "arxiv": (dataclasses.replace(J_ARXIV, n_points=400),
              dataclasses.replace(OGB_ARXIV_LIKE, n_points=400)),
    "products": (dataclasses.replace(J_PRODUCTS, n_points=400),
                 dataclasses.replace(OGB_PRODUCTS_LIKE, n_points=400)),
}
BUCKETS = dict(dense_tables=8, dense_bits=10, set_tables=6,
               scalar_widths=(2.0,))


def _near_zero_rows(feats, jgen) -> np.ndarray:
    """Rows whose SimHash projection lies within 1e-5 of zero somewhere:
    a float32 product in another summation order may flip that sign."""
    near = np.zeros(next(iter(feats.values())).shape[0], bool)
    for key, planes in jgen.params.items():
        x = feats["dense:" + key.split(":", 1)[1]].astype(np.float64)
        proj = np.einsum("bd,tdk->btk", x, np.asarray(planes, np.float64))
        near |= (np.abs(proj) < 1e-5).any(axis=(1, 2))
    return near


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_buckets_and_embedding_bitwise(corpus):
    data_j, data_t = CORPORA[corpus]
    ids, feats, _ = make_dataset(data_t)
    _, jfeats, _ = j_make_dataset(data_j)
    for k in feats:                               # byte-identical corpora
        np.testing.assert_array_equal(feats[k], jfeats[k])
    jgen, tgen = _generators(data_j, data_t, **BUCKETS)
    near = _near_zero_rows(feats, jgen)
    print(f"{corpus}: {int(near.sum())} rows with |proj| < 1e-5 excluded")
    keep = ~near
    jb, jv = jgen.buckets(feats)
    tb, tv = tgen.buckets(feats)
    np.testing.assert_array_equal(np.asarray(jb).astype(np.int64)[keep],
                                  tb.numpy()[keep])
    np.testing.assert_array_equal(np.asarray(jv)[keep], tv.numpy()[keep])

    # with IDF weights and a popular-bucket filter built on both sides
    bid, valid = np.asarray(jb), np.asarray(jv)
    jgen = jgen.reload(j_build_idf_table(bid, valid, len(ids), 500),
                       j_build_filter_table(bid, valid, 5.0))
    tgen = tgen.reload(build_idf_table(bid, valid, len(ids), 500, "cpu"),
                       build_filter_table(bid, valid, 5.0, "cpu"))
    for j_tab, t_tab in ((jgen.idf.sorted_ids, tgen.idf.sorted_ids),
                         (jgen.idf.weights, tgen.idf.weights),
                         (jgen.filter.sorted_ids, tgen.filter.sorted_ids)):
        np.testing.assert_array_equal(np.asarray(j_tab).astype(
            t_tab.numpy().dtype), t_tab.numpy())
    assert float(jgen.idf.default_weight) == float(tgen.idf.default_weight)
    je, te = jgen(feats), tgen(feats)
    np.testing.assert_array_equal(np.asarray(je.indices).astype(np.int64)[keep],
                                  te.indices.numpy()[keep])
    np.testing.assert_array_equal(np.asarray(je.values)[keep],
                                  te.values.numpy()[keep])
    # and the CountSketch of identical embeddings is bitwise (the main
    # path's corpus, d_proj and seed)
    if corpus != "arxiv":
        return
    np.testing.assert_array_equal(
        np.asarray(j_count_sketch(je, 64, 13)),
        count_sketch(te.__class__(torch.as_tensor(
            np.asarray(je.indices).astype(np.int64)),
            torch.as_tensor(np.array(je.values))), 64, 13).numpy())


def test_sort_sparse_bitwise():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 50, (64, 12)).astype(np.uint32)   # repeats
    idx[:, ::5] = 0xFFFFFFFF
    val = rng.choice(np.asarray([0.0, 0.5, 1.0, 2.0], np.float32), (64, 12))
    want = j_sort_sparse(jnp.asarray(idx), jnp.asarray(val))
    got = sort_sparse(torch.as_tensor(idx.astype(np.int64)),
                      torch.as_tensor(val))
    np.testing.assert_array_equal(np.asarray(want.indices).astype(np.int64),
                                  got.indices.numpy())
    np.testing.assert_array_equal(np.asarray(want.values), got.values.numpy())
    assert (got.indices.numpy()[:, -1] == PAD_INDEX).any()
