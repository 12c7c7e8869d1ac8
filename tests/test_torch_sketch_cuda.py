"""The CountSketch kernel (``kernels/csrc/sketch.cu``) against its plain
version, bitwise (sign bits compared), on the card: from 1 to 1,469,417
rows (the products bootstrap's), at arxiv's 9 and products' 14 columns
and d_proj 16, 32, 64 and 512; row-strided inputs; the summation-order,
cancellation, padding and empty cases of ``kernels/cases.py``; one launch
per ``ScannIndex.search``; and the inputs it refuses. Whether there is a
card is decided in the ``card`` fixture, so without one every test here
skips. Run on the H100 with

    python -m pytest -q -m cuda tests/test_torch_sketch_cuda.py

This file imports no jax; ``tests/test_torch_sketch.py`` holds the
kernel's arithmetic and the plain version against the reference on the
CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.ann import ScannConfig, ScannIndex
from repro_torch.core import BucketConfig
from repro_torch.core.embedding import EmbeddingGenerator
from repro_torch.core.types import SparseBatch
from repro_torch.data.synthetic import OGB_ARXIV_LIKE, make_dataset
from repro_torch.kernels import cases, ops, sketch

pytestmark = pytest.mark.cuda

NEG_ZERO = -2 ** 31


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _both(indices, values, d_proj: int, seed: int, card):
    """(kernel on the card, plain on the CPU) of the same numpy inputs,
    the kernel's launches checked: one a call with rows, none without."""
    before = ops.launch_counts()["count_sketch"]
    got = sketch.count_sketch(torch.as_tensor(indices).to(card),
                              torch.as_tensor(values).to(card), d_proj, seed)
    torch.cuda.synchronize()
    assert ops.launch_counts()["count_sketch"] == \
        before + (indices.shape[0] > 0)
    want = sketch.count_sketch(torch.as_tensor(indices),
                               torch.as_tensor(values), d_proj, seed)
    return got.cpu(), want


def _assert_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("rows,k,d_proj", [
    (rows, k, d_proj) for rows in (1, 16, 1024, 100_003, 1_469_417)
    for k in (9, 14) for d_proj in (16, 32, 64, 512)]
    + [(1024, 40, 16), (1024, 40, 512), (333, 70, 64)])
def test_kernel_matches_plain_bitwise(card, rows, k, d_proj):
    """Every coordinate bit for bit the plain version's; 100,003 rows
    fill no whole block, 1,469,417 are the products bootstrap's; 40 and
    70 columns take a warp's lanes two and three times."""
    indices, values = cases.sketch_inputs(np.random.default_rng(rows + k),
                                          rows, k)
    got, want = _both(indices, values, d_proj, 7 + k, card)
    _assert_bits(got, want)
    assert not (got.view(torch.int32) == NEG_ZERO).any()


@pytest.mark.parametrize("layout", ("column slice", "every other row",
                                    "column-major"))
def test_strided_inputs(card, layout):
    """Indices and values read through their strides: a column slice of
    wider rows, every other row of a taller array, a transposed copy."""
    rows, k = 333, 14
    indices, values = cases.sketch_inputs(np.random.default_rng(3), rows, k)

    def strided(a):
        t = torch.as_tensor(a)
        if layout == "column slice":
            wide = torch.zeros((rows, k + 3), dtype=t.dtype)
            wide[:, 3:] = t
            return wide.to(card)[:, 3:]
        if layout == "every other row":
            return torch.stack([t, t + 1], 1).reshape(2 * rows, k).to(
                card)[::2]
        return t.t().contiguous().to(card).t()

    idx, val = strided(indices), strided(values)
    assert not idx.is_contiguous() and not val.is_contiguous()
    got = sketch.count_sketch(idx, val, 64, 13).cpu()
    want = sketch.count_sketch(torch.as_tensor(indices),
                               torch.as_tensor(values), 64, 13)
    _assert_bits(got, want)


@pytest.mark.parametrize("name", [c[0] for c in cases.sketch_edge_cases()])
def test_edge_cases(card, name):
    """Column order, exact cancellation to +0.0, -0.0 and NaN at padding,
    no rows (an empty [0, d_proj], no launch): bit for bit the plain
    version, no coordinate -0.0."""
    _, indices, values = dict((c[0], c) for c in
                              cases.sketch_edge_cases())[name]
    for d_proj in (16, 64):
        got, want = _both(indices, values, d_proj, 7, card)
        _assert_bits(got, want)
        assert not (got.view(torch.int32) == NEG_ZERO).any()
        assert torch.isfinite(got).all()


def _index(card):
    """A ScannIndex built on the card from 900 embedded points, and the
    embeddings (on the CPU)."""
    data = dataclasses.replace(OGB_ARXIV_LIKE, n_points=900, n_clusters=12)
    ids, feats, _ = make_dataset(data)
    gen = EmbeddingGenerator.create(
        data.spec, BucketConfig(dense_tables=8, dense_bits=10,
                                scalar_widths=(2.0,)), device="cpu")
    emb = gen(feats)
    idx = ScannIndex(gen.k_max, ScannConfig(d_proj=64, n_partitions=16,
                                            nprobe=4), device=card)
    idx.build(ids, SparseBatch(emb.indices.to(card), emb.values.to(card)))
    return idx, emb


@pytest.mark.parametrize("rows", (16, 1024))
def test_one_launch_per_search(card, rows):
    """``ScannIndex.search`` sketches its queries in exactly one launch,
    at an RPC's 16 rows and a bulk RPC's 1,024."""
    idx, emb = _index(card)
    take = torch.arange(rows) % emb.batch
    q = SparseBatch(emb.indices[take].to(card), emb.values[take].to(card))
    for _ in range(2):
        before = ops.launch_counts()["count_sketch"]
        idx.search(q, 10)
        torch.cuda.synchronize()
        assert ops.launch_counts()["count_sketch"] == before + 1


@pytest.mark.parametrize("what", ("int32 indices", "float64 values",
                                  "devices", "rank", "d_proj past the cap"))
def test_refusals(card, what):
    """What the kernel does not take raises before any launch."""
    idx = torch.zeros((4, 9), dtype=torch.int64, device=card)
    val = torch.zeros((4, 9), dtype=torch.float32, device=card)
    d_proj = 64
    if what == "int32 indices":
        idx = idx.to(torch.int32)
    elif what == "float64 values":
        val = val.to(torch.float64)
    elif what == "devices":
        val = val.cpu()
    elif what == "rank":
        idx, val = idx[0], val[0]
    else:
        d_proj = sketch.max_d_proj() + 1
    before = ops.launch_counts()["count_sketch"]
    with pytest.raises(ValueError, match="count_sketch"):
        sketch.count_sketch(idx, val, d_proj, 7)
    assert ops.launch_counts()["count_sketch"] == before
