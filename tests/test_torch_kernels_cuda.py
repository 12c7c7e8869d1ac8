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

from repro_torch.ann.brute import BruteIndex
from repro_torch.core.scorer import pair_layout
from repro_torch.core.types import PAD_INDEX, SparseBatch
from repro_torch.data.synthetic import OGB_ARXIV_LIKE, OGB_PRODUCTS_LIKE
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


@pytest.mark.parametrize("b,n,k", [(16, 8192, 128), (16, 16384, 128),
                                   (16, 65536, 128), (16, 300, 300),
                                   (16, 1000, 1), (256, 32768, 128)])
def test_fused_query_matches_plain_bitwise(card, b, n, k):
    """M=8, C=256 as on the main path: B=16 at N = nprobe x the offline
    slab (8 x 1,024), a doubled slab (the arxiv run of chip_smoke.py
    reaches N = 32,768), 16 chunks merged in one block, k = N and k = 1
    (rows of one chunk); B=256 (graph seeding, the repair drain) at the
    main path's N = 32,768."""
    rng = np.random.default_rng(n + k)
    _fq_check(cases.fused_query_inputs(rng, b, n, 8, 256, max(2, n // 3),
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
    # bitwise: the plain version sums in the kernel's order
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("unit", [True, False])
def test_sparse_dot_batched_multimodal_shape(card, unit):
    """The two-stage retrieval's exact distances: 16 queries of K = 14
    (the products buckets) against their 21 candidates (11 dense + 10
    sparse), the rows of missing candidates all padding."""
    rng = np.random.default_rng(2)
    q = cases.sparse_rows(rng, (16, 14), 40, unit)
    db = cases.sparse_rows(rng, (16, 21, 14), 40, unit)
    db[0][:, 15:] = PAD_INDEX                     # candidates -1
    db[1][:, 15:] = 0.0
    args = [torch.as_tensor(a).to(card) for a in (*q, *db)]
    before = sparse_dot.sparse_dot_batched.launches
    got = sparse_dot.sparse_dot_batched(*args)
    want = sparse_dot.sparse_dot_plain(*args)
    torch.cuda.synchronize()
    assert sparse_dot.sparse_dot_batched.launches == before + 1
    assert _bits_equal(got, want)
    assert (got[:, 15:] == 0).all()


def _bits_equal(got, want) -> bool:
    """f32 tensors equal bit for bit (the signs of zeros included)."""
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n,unit", [(262_144, True), (4099, False)])
def test_sparse_dot_shared_db_matches_plain(card, n, unit):
    """The brute-force form at the capacity the arxiv-scale index reaches
    (N = 262,144, 64 queries) and at a ragged N with IDF-like weights;
    bitwise (the plain version sums in the kernel's order)."""
    rng = np.random.default_rng(n)
    q = cases.sparse_rows(rng, (64, 9), 5000, unit)
    db = cases.sparse_rows(rng, (n, 9), 5000, unit)
    args = [torch.as_tensor(a).to(card) for a in (*q, *db)]
    before = sparse_dot.sparse_dot.launches
    got = ops.sparse_dot(*args)
    want = sparse_dot.sparse_dot_plain(*args)
    torch.cuda.synchronize()
    assert sparse_dot.sparse_dot.launches == before + 1
    assert _bits_equal(got, want)


@pytest.mark.parametrize("name", ["B=1", "B=63", "B=64", "B=300",
                                  "Kq=40 Kd=5", "Kq=3 Kd=16", "padding rows",
                                  "repeated indices", "row mask"])
def test_sparse_dot_shared_db_cases(card, name):
    """The shared form's query chunks, index tables and masks
    (``cases.sparse_dot_cases``), bitwise with IDF-like weights."""
    arrays = dict(cases.sparse_dot_cases(np.random.default_rng(3)))[name]
    args = [None if a is None else torch.as_tensor(a).to(card)
            for a in arrays]
    got = ops.sparse_dot(*args)
    want = sparse_dot.sparse_dot_plain(*args)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)
    if name == "row mask":
        assert torch.isneginf(got[:, ~args[4]]).all()


def _brute(dev, rows, capacity: int = 1024) -> BruteIndex:
    """A brute index on ``dev`` holding ``rows`` (ids 0..N-1), every
    third of the first 3,000 deleted and 500 updated from later rows."""
    idx, val = (torch.as_tensor(a) for a in rows)
    ids = np.arange(len(idx))
    index = BruteIndex(idx.shape[1], capacity, device=dev)
    index.upsert(ids, SparseBatch(idx.to(dev), val.to(dev)))
    index.delete(ids[:3000:3])
    index.upsert(ids[3000:3500], SparseBatch(idx[-500:].to(dev),
                                             val[-500:].to(dev)))
    return index


@pytest.mark.parametrize("unit", [True, False])
def test_brute_search_matches_cpu(card, unit):
    """BruteIndex.search on the card (the masked sparse-dot kernel, then
    the split top-k in lax.top_k's order) equals the same index on the
    CPU: 64 queries, k = 10 and k = 300, a 131,072-slot index with
    tombstones; vocabulary 300, so scores tie and many rows score 0;
    ids exactly, distances bitwise."""
    rng = np.random.default_rng(15)
    rows = cases.sparse_rows(rng, (100_000, 9), 300, unit)
    q = [torch.as_tensor(a) for a in cases.sparse_rows(rng, (64, 9), 300,
                                                       unit)]
    on_card, on_cpu = _brute(card, rows), _brute("cpu", rows)
    assert on_card.capacity == 131_072
    for k in (10, 300):
        before = sparse_dot.sparse_dot.launches
        got = on_card.search(SparseBatch(q[0].to(card), q[1].to(card)), k)
        want = on_cpu.search(SparseBatch(*q), k)
        assert sparse_dot.sparse_dot.launches == before + 1
        np.testing.assert_array_equal(got[0], want[0])
        assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32))


def test_brute_search_refuses_k_past_split(card):
    """A k past the split top-k's old limit (k = 4,097 on a 16,384-slot
    index) is no longer refused: the card answers it as the same index
    answers on the CPU, ids exactly, distances bitwise. (The name is the
    one the test had when it pinned the refusal.)"""
    rng = np.random.default_rng(16)
    rows = cases.sparse_rows(rng, (9000, 9), 300, True)
    on_card, on_cpu = _brute(card, rows), _brute("cpu", rows)
    assert on_card.capacity == 16_384
    q = [torch.as_tensor(a) for a in cases.sparse_rows(rng, (4, 9), 300,
                                                       True)]
    got = on_card.search(SparseBatch(q[0].to(card), q[1].to(card)), 4097)
    want = on_cpu.search(SparseBatch(*q), 4097)
    np.testing.assert_array_equal(got[0], want[0])
    assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32))


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


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("name", ["B=4 N=32768 k=4097",
                                  "B=2 N=131072 k=16384",
                                  "B=3 N=40000 k=5000",
                                  "B=2 N=20000 k=20000"])
def test_topk_select_past_half_chunk(card, name, signed):
    """k above half a chunk on rows of several chunks (the pairwise merge
    of the chunks' sorted runs), bitwise in both signed-zero orders, with
    +0.0 and -0.0 inside every cut (cases.topk_long_k_cases)."""
    scores, k = {n: (s, k) for n, s, k in
                 cases.topk_long_k_cases(np.random.default_rng(21))}[name]
    scores = torch.as_tensor(scores).to(card)
    before = topk_select.topk_select.launches
    got = topk_select.topk_select(scores, k, signed_zeros=signed)
    want = topk_select.topk_select_plain(scores, k, signed_zeros=signed)
    torch.cuda.synchronize()
    assert topk_select.topk_select.launches == before + 1
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("int8", [False, True])
def test_fused_query_past_half_chunk(card, int8):
    """The fused shortlist at k = 4,097 over N = 32,768 candidates (past
    what its one merge block takes) stays on the fused kernel (the
    pairwise merge and the dedup kernel), bitwise its plain version, ties
    and duplicate ids included."""
    rng = np.random.default_rng(23)
    case = cases.fused_query_inputs(rng, 2, 32768, 8, 256, 20000, 0.1,
                                    ties=True)
    args = [torch.as_tensor(case[name]).to(card) for name in cases.FQ_ORDER]
    table = ops.quantize_lut(args[0]) if int8 else (args[0],)
    kernel, plain = ((fused_query.fused_query_kernel_int8,
                      fused_query.fused_query_int8_plain) if int8 else
                     (fused_query.fused_query_kernel,
                      fused_query.fused_query_plain))
    before = (kernel.launches, pq_score.pq_score_batched.launches,
              topk_select.topk_select.launches)
    got = kernel(*table, *args[1:], 4097)
    want = plain(*table, *args[1:], 4097)
    torch.cuda.synchronize()
    assert (kernel.launches, pq_score.pq_score_batched.launches,
            topk_select.topk_select.launches) == (before[0] + 1, *before[1:])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.isinf(got[0]).any() and torch.isfinite(got[0]).any()


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
    assert _bits_equal(got, want)


@pytest.mark.parametrize("name", [
    "M=4 C=16 B=1 N=1001 batched", "M=8 C=256 B=300 N=777 batched",
    "M=16 C=256 B=3 N=4097 batched", "M=16 C=16 B=300 N=1001 shared",
    "M=4 C=256 B=1 N=70001 shared", "M=8 C=16 B=17 N=5000 shared",
    "M=5 C=20 B=3 N=1001 batched", "offset view"])
def test_pq_score_load_paths(card, name):
    """Every code-load path of the kernel (``cases.pq_score_cases``):
    4-, 8- and 16-byte words, bytes at an odd M and at codes one byte off
    their buffer, several tables a block in the shared form; bitwise."""
    lut, codes, shared = {c[0]: c[1:] for c in
                          cases.pq_score_cases(np.random.default_rng(4))}[name]
    lut = torch.as_tensor(lut).to(card)
    codes = torch.as_tensor(codes).to(card)
    if name == "offset view":
        buf = torch.empty(codes.numel() + 1, dtype=torch.uint8, device=card)
        buf[1:].copy_(codes.flatten())
        codes = buf[1:].view(codes.shape)
        assert codes.is_contiguous() and codes.data_ptr() % 8 == 1
    fn = pq_score.pq_score if shared else pq_score.pq_score_batched
    got = fn(lut, codes)
    want = pq_score.pq_score_plain(lut, codes)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)


def _rescore_check(case, k, dev):
    """sparse_rescore_topk against its plain version: one launch, slots
    and distances (sign bits included) bitwise."""
    args = [torch.as_tensor(case[name]).to(dev)
            for name in cases.RESCORE_ORDER]
    before = sparse_dot.sparse_rescore_topk.launches
    got = ops.sparse_rescore_topk(*args, k)
    want = sparse_dot.sparse_rescore_topk_plain(*args, k)
    torch.cuda.synchronize()
    assert sparse_dot.sparse_rescore_topk.launches == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    return got


@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("b,k", [(16, 11), (16, 17), (256, 11), (256, 17)])
def test_sparse_rescore_topk_matches_plain_bitwise(card, b, k, unit):
    """The index's rescore step at the main path's B=16 and the graph
    seeding's B=256: N = 32,768 candidates, r = 128, a slab of 262,144
    rows of K = 9, k = 11 (main) and 17 (graph probe). Unit values from a
    vocabulary of 40 make ties across shortlist positions; IDF-like values
    test the summation order; -1 slots, -inf entries and an all-invalid
    row 0 in both."""
    rng = np.random.default_rng(b + k)
    case = cases.rescore_inputs(rng, b, 32768, 128, 262_144, 9, 40, unit)
    slots, dists = _rescore_check(case, k, card)
    assert (slots[0] == -1).all() and torch.isposinf(dists[0]).all()
    if unit:
        assert (dists[1:, 1:] == dists[1:, :-1]).any()   # ties in the cut


@pytest.mark.parametrize("r", [1, 300, 1023, 2048, 8192])
def test_sparse_rescore_topk_shortlist_lengths(card, r):
    """A shortlist of one, one over two tiles of 128 entries with a ragged
    end and a non-power-of-two sort, one above the default shared memory
    (2,048), and the one-block kernel's largest (8,192); past it, r =
    8,193 (refused before the keys route) equals its plain version too."""
    rng = np.random.default_rng(r)
    n = max(4096, r)
    case = cases.rescore_inputs(rng, 4, n, r, 5000, 9, 40, True)
    _rescore_check(case, min(r, 17), card)
    if r == sparse_dot.MAX_REORDER:
        case = cases.rescore_inputs(rng, 2, r + 1, r + 1, 5000, 9, 40, True)
        _rescore_check(case, 10, card)


@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("r,k", [(8193, 17), (8193, 5000), (16384, 11),
                                 (16384, 16384)])
def test_sparse_rescore_topk_long_shortlists(card, r, k, unit):
    """Shortlists past the one-block kernel (r > 8,192): the keys tile by
    tile into a [B, r] scratch, then the split top-k, with the halving
    merge (small k) or the pairwise one (k = 5,000 and k = r), bitwise
    its plain version at unit and IDF-like values."""
    rng = np.random.default_rng(r + k)
    case = cases.rescore_inputs(rng, 3, r + 100, r, 20_000, 9, 40, unit)
    slots, _ = _rescore_check(case, k, card)
    assert slots.shape == (3, k) and (slots[0] == -1).all()


@pytest.mark.parametrize("p,group", [(160, 1), (160, 10), (4096, 1),
                                     (4000, 10), (4096, 16)])
@pytest.mark.parametrize("which", ["arxiv", "products"])
def test_pair_score_matches_plain(card, which, group, p):
    """Pair features and the MLP in one launch against pair_features +
    the plain MLP on the query rows repeated ``group`` times: the arxiv
    spec (dense 128, a scalar) and the products spec (dense 100, a set of
    16); P = 160 (16 queries x 10 neighbors, or aligned), about 4,000
    aligned or in groups of 10, and 4,096 in groups of 16 (a graph
    seeding chunk of 256 x probe 16); rtol 1e-5, atol 1e-6 (norms and
    sums reduced in another order)."""
    spec = {"arxiv": OGB_ARXIV_LIKE, "products": OGB_PRODUCTS_LIKE}[
        which].spec
    keys, layout = pair_layout(spec)
    rng = np.random.default_rng(p + group)
    fq = cases.feature_rows(rng, spec, p // group)
    fc = cases.feature_rows(rng, spec, p)
    weights = [torch.as_tensor(a).to(card) for a in
               cases.scorer_inputs(rng, 1, layout.n_features, 10)[1:]]
    q = [torch.as_tensor(fq[key]).to(card) for key in keys]
    c = [torch.as_tensor(fc[key]).to(card) for key in keys]
    before = scorer_mlp.pair_score.launches
    got = scorer_mlp.pair_score(q, c, layout, group, *weights)
    want = scorer_mlp.pair_score_plain(q, c, layout, group, *weights)
    torch.cuda.synchronize()
    assert scorer_mlp.pair_score.launches == before + 1
    assert got.shape == (p,)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
