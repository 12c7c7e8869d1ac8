"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Whether there is a card is decided in the ``card`` fixture, so
without one every test here skips. Run on the H100 with

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

This file imports no jax: the machine with the card has none. The port's
agreement with the reference is held by the CPU tests (test_torch_*.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.types import PAD_INDEX
from repro_torch.kernels import (cases, fused_query, ops, pq_score,
                                  scorer_mlp, sparse_dot, topk_select)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fq_check(case, k, dev):
    args = [torch.as_tensor(case[name]).to(dev) for name in cases.FQ_ORDER]
    before = fused_query.fused_query_kernel.launches
    got = fused_query.fused_query_kernel(*args, k)
    want = fused_query.fused_query_plain(*args, k)
    torch.cuda.synchronize()
    assert fused_query.fused_query_kernel.launches == before + 1
    # bitwise: values (with -inf placement) and indices (tie order)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    return got


@pytest.mark.parametrize("n,k", [(8192, 128), (16384, 128), (65536, 128),
                                 (300, 300), (1000, 1)])
def test_fused_query_matches_plain_bitwise(card, n, k):
    """B=16, M=8, C=256 as on the main path: N = nprobe x the offline
    slab (8 x 1,024), a doubled slab (the arxiv run of chip_smoke.py
    reaches N = 32,768), 16 chunks merged in one block, k = N and k = 1
    (rows of one chunk)."""
    rng = np.random.default_rng(n + k)
    _fq_check(cases.fused_query_inputs(rng, 16, n, 8, 256, max(2, n // 3),
                                       0.3), k, card)


@pytest.mark.parametrize("name", ["ties+dups", "all-invalid", "k=n",
                                  "k=live rows", "uniform"])
def test_fused_query_edge_cases(card, name):
    edge = {n: (case, k) for n, case, k in
            cases.fused_query_edge_cases(np.random.default_rng(7))}
    case, k = edge[name]
    vals, idxs = _fq_check(case, k, card)
    if name == "all-invalid":
        # all-invalid rows select 0..k-1 with -inf values
        assert torch.isneginf(vals).all()
        assert torch.equal(idxs.cpu(), torch.arange(k, dtype=torch.int32)
                           .repeat(2, 1))
    if name == "uniform":
        # uniform scores keep candidate order; later copies become -inf
        assert torch.equal(idxs.cpu()[0], torch.arange(8, dtype=torch.int32))
        assert torch.isfinite(vals.cpu()[0]).tolist() == [
            True, False, False, True, False, True, False, False]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", ["ragged chunk", "short row k=N",
                                  "copies across chunks", "all-invalid long"])
def test_fused_query_split_cases(card, name, int8):
    """Rows split into chunks of ``topk_select.CHUNK`` candidates (one
    probed slab): a ragged last chunk, a row shorter than a chunk with
    k = N, SOAR copies in different chunks, all-invalid rows over three
    chunks; f32 and int8 tables."""
    rng = np.random.default_rng(17)
    case, k = {n: (c, k) for n, c, k in
               cases.fused_query_split_cases(rng, topk_select.CHUNK)}[name]
    if not int8:
        vals, idxs = _fq_check(case, k, card)
    else:
        args = [torch.as_tensor(case[a]).to(card) for a in cases.FQ_ORDER]
        table = ops.quantize_lut(args[0])
        vals, idxs = fused_query.fused_query_kernel_int8(*table, *args[1:], k)
        want = fused_query.fused_query_int8_plain(*table, *args[1:], k)
        torch.cuda.synchronize()
        assert torch.equal(idxs, want[1]) and torch.equal(vals, want[0])
    if name == "all-invalid long":
        assert torch.isneginf(vals).all()
        assert torch.equal(idxs.cpu(), torch.arange(k, dtype=torch.int32)
                           .repeat(2, 1))


@pytest.mark.parametrize("unit", [True, False])
def test_sparse_dot_batched_matches_plain(card, unit):
    """The rescore at its main-path shape: B=16, R=128, Kq=Kd=9."""
    rng = np.random.default_rng(1)
    q = cases.sparse_rows(rng, (16, 9), 40, unit)
    db = cases.sparse_rows(rng, (16, 128, 9), 40, unit)
    db[0][3] = PAD_INDEX                          # an all-padded row block
    args = [torch.as_tensor(a).to(card) for a in (*q, *db)]
    before = sparse_dot.sparse_dot_batched.launches
    got = sparse_dot.sparse_dot_batched(*args)
    want = sparse_dot.sparse_dot_plain(*args)
    torch.cuda.synchronize()
    assert sparse_dot.sparse_dot_batched.launches == before + 1
    if unit:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,unit", [(262_144, True), (4099, False)])
def test_sparse_dot_shared_db_matches_plain(card, n, unit):
    """The brute-force form at the capacity the arxiv-scale index reaches
    (N = 262,144, 64 queries) and at a ragged N with IDF-like weights."""
    rng = np.random.default_rng(n)
    q = cases.sparse_rows(rng, (64, 9), 5000, unit)
    db = cases.sparse_rows(rng, (n, 9), 5000, unit)
    args = [torch.as_tensor(a).to(card) for a in (*q, *db)]
    before = sparse_dot.sparse_dot.launches
    got = ops.sparse_dot(*args)
    want = sparse_dot.sparse_dot_plain(*args)
    torch.cuda.synchronize()
    assert sparse_dot.sparse_dot.launches == before + 1
    if unit:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,f,h", [(160, 3, 10), (1, 7, 32), (1000, 5, 1)])
def test_scorer_mlp_matches_plain(card, b, f, h):
    rng = np.random.default_rng(b + f + h)
    args = [torch.as_tensor(a).to(card)
            for a in cases.scorer_inputs(rng, b, f, h)]
    before = scorer_mlp.scorer_mlp.launches
    got = scorer_mlp.scorer_mlp(*args)
    want = scorer_mlp.scorer_mlp_plain(*args)
    torch.cuda.synchronize()
    assert scorer_mlp.scorer_mlp.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [16384, 32768])
def test_fused_query_int8_matches_plain_bitwise(card, n):
    """The int8 shortlist at B=16, M=8, C=256, k=128: N = 16,384 and the
    main path's 32,768; the table is quantised on the card."""
    rng = np.random.default_rng(n)
    case = cases.fused_query_inputs(rng, 16, n, 8, 256, n // 3, 0.3)
    args = [torch.as_tensor(case[name]).to(card) for name in cases.FQ_ORDER]
    qlut, scale = ops.quantize_lut(args[0])
    before = fused_query.fused_query_kernel_int8.launches
    got = fused_query.fused_query_kernel_int8(qlut, scale, *args[1:], 128)
    want = fused_query.fused_query_int8_plain(qlut, scale, *args[1:], 128)
    torch.cuda.synchronize()
    assert fused_query.fused_query_kernel_int8.launches == before + 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("name", ["ties+dups", "all-invalid", "k=n",
                                  "k=live rows", "uniform"])
def test_fused_query_int8_edge_cases(card, name):
    edge = {n: (case, k) for n, case, k in
            cases.fused_query_edge_cases(np.random.default_rng(7))}
    case, k = edge[name]
    args = [torch.as_tensor(case[a]).to(card) for a in cases.FQ_ORDER]
    qlut, scale = ops.quantize_lut(args[0])
    got = fused_query.fused_query_kernel_int8(qlut, scale, *args[1:], k)
    want = fused_query.fused_query_int8_plain(qlut, scale, *args[1:], k)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def _topk_check(scores, k, dev):
    """ops.topk_select (the kernel, in the order the reference's routing
    names for k) against its plain version, bitwise with sign bits."""
    scores = torch.as_tensor(scores).to(dev)
    before = topk_select.topk_select.launches
    got = ops.topk_select(scores, k)
    want = topk_select.topk_select_plain(scores, k, signed_zeros=k > 64)
    torch.cuda.synchronize()
    assert topk_select.topk_select.launches == before + 1
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    return got


@pytest.mark.parametrize("name", ["merge ties", "read ties", "k=N", "k=1",
                                  "scratch", "signed zeros k<=64",
                                  "signed zeros k>64"])
def test_topk_select_matches_plain_bitwise(card, name):
    """The graph's merge shape (1,024 rows of width + candidates = 128,
    k = 64) and read shape (16 rows of 64, k = 8) with ties and all -inf
    rows, k = N, k = 1, a 2M-entry row (489 chunks, merged in one block),
    and signed zeros in both orders (short rows: one warp each)."""
    edge = {n: (s, k) for n, s, k in
            cases.topk_edge_cases(np.random.default_rng(5))}
    scores, k = edge[name]
    got = _topk_check(scores, k, card)
    if name == "merge ties":
        assert torch.equal(got[1][0].cpu(), torch.arange(k, dtype=torch.int32))


@pytest.mark.parametrize("name", ["equal values", "ragged zeros"])
def test_topk_select_split_cases(card, name):
    """Rows split into chunks of ``topk_select.CHUNK``: equal values over
    eight chunks select 0..127 (ties across chunk boundaries), and signed
    zeros with a ragged last chunk."""
    scores, k = {n: (s, k) for n, s, k in
                 cases.topk_split_cases(topk_select.CHUNK)}[name]
    got = _topk_check(scores, k, card)
    if name == "equal values":
        assert torch.equal(got[1].cpu(), torch.arange(k, dtype=torch.int32)
                           .repeat(2, 1))


@pytest.mark.parametrize("b,n,k", [(64, 32768, 128), (1024, 144, 80),
                                   (256, 5000, 2049), (4, 600_000, 128)])
def test_topk_select_above_64_matches_plain(card, b, n, k):
    """Above k = 64 (lax.top_k's order): the unfused shortlist's top-r, a
    GraphConfig(k=10) merge, a k above CHUNK / 2 (a doubled chunk), and a
    row whose survivors are merged twice (147 chunks, then 5)."""
    _topk_check(cases.topk_inputs(np.random.default_rng(n), b, n), k, card)


@pytest.mark.parametrize("form,b,n,m,c", [("batched", 16, 32768, 8, 256),
                                          ("shared", 16, 131072, 8, 256),
                                          ("batched", 3, 1001, 5, 20)])
def test_pq_score_matches_plain_bitwise(card, form, b, n, m, c):
    """The fused=False shortlist's shape (B=16, N=32,768), the shared form
    at N=131,072, and a ragged N with odd M and C."""
    case = cases.fused_query_inputs(np.random.default_rng(n), b, n, m, c, 2,
                                    0.0)
    lut = torch.as_tensor(case["lut"]).to(card)
    codes = torch.as_tensor(case["codes"]).to(card)
    fn = pq_score.pq_score_batched
    if form == "shared":
        codes, fn = codes[0].contiguous(), pq_score.pq_score
    before = fn.launches
    got = fn(lut, codes)
    want = pq_score.pq_score_plain(lut, codes)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, want)
