"""The top-k order at signed zeros, and the split-and-merge order of work
of the top-k and fused-shortlist kernels, on the CPU.

* ``ops.topk_select`` against the reference's ``ops.topk_select`` (its
  Pallas kernel in interpret mode at k <= 64, ``lax.top_k`` above) where
  -0.0 and +0.0 tie, and ``ref.topk_ref`` against ``lax.top_k``:
  bitwise, the values' sign bits included.
* A plain model of what ``csrc/topk_select.cu`` and ``csrc/fused_query.cu``
  compute on a long row: packed (value, index) keys, each chunk's
  top-min(k, chunk), the survivors merged (again, while the row is longer
  than a chunk; or, at k > chunk / 2, the chunks' sorted runs merged
  pairwise by merge-path splits, as ``select.cuh::merge_runs`` does), the
  row's top-k, then the dedup-after-cut with one check per entry. It is
  written here, not in the package, and held bitwise against the plain
  versions and the reference over the split edge cases of
  ``kernels/cases.py`` at several chunk sizes, chunk < k among them.
  That shows on the CPU that the decomposition is exact; the card tests
  hold the kernels against the plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import cases, fused_query, ops, ref, topk_select
from repro_torch.kernels.ref import pq_score_seq_ref

assert jax.default_backend() == "cpu"

CHUNKS = (8, 24, 64, 1024)      # 8 and 24 < k for k = 16 and k = 53


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


# ------------------------------------------------------- signed zeros

@pytest.mark.parametrize("k", [4, 12, 70])
def test_topk_select_signed_zeros_match_reference(k):
    """At k <= 64 -0.0 and +0.0 tie and each round writes the maximum of
    the entries still alive; above 64 +0.0 ranks first and each entry
    keeps its value (cases.signed_zero_rows, the reference's answers)."""
    rows = cases.signed_zero_rows()
    want = jops.topk_select(jnp.asarray(rows), k, interpret=True)
    got = ops.topk_select(torch.as_tensor(rows), k)
    _assert_bitwise((got[0].numpy(), got[1].numpy()), want)
    if k == 4:
        assert got[1][0].tolist() == [5, 0, 1, 2]
        assert not np.signbit(got[0][0].numpy()).any()
    if k == 70:
        assert got[1][0, :4].tolist() == [5, 1, 3, 7]


def test_topk_ref_signed_zeros_match_lax_top_k():
    """``topk_ref`` stands for ``lax.top_k`` wherever it runs (the index's
    partition pick and final cut): +0.0 above -0.0, each entry its own
    value, at any k."""
    rows = np.concatenate([cases.signed_zero_rows(),
                           cases.signed_zero_rows()[:, ::-1]])
    for k in (1, 7, 80):
        want = jax.lax.top_k(jnp.asarray(rows), k)
        got = ref.topk_ref(torch.as_tensor(rows), k)
        _assert_bitwise((got[0].numpy(), got[1].numpy()), want)


# ------------------------------------------------ the split, modelled

def _keys(scores: torch.Tensor, tie_zeros: bool) -> torch.Tensor:
    """f32 [B, N] -> unique int64 keys, larger = earlier: the value's
    order-preserving image (-0.0 read as +0.0 when ``tie_zeros``), then
    the lower index."""
    bits = scores.contiguous().view(torch.int32).to(torch.int64)
    if tie_zeros:
        bits = torch.where(bits == -2 ** 31, 0, bits)
    img = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.arange(scores.shape[1], dtype=torch.int64)
    return img * 2 ** 32 + (2 ** 32 - 1 - idx)


def _unkey(keys: torch.Tensor):
    img = keys >> 32
    bits = torch.where(img < 0, img ^ 0x7FFFFFFF, img).to(torch.int32)
    idx = 2 ** 32 - 1 - (keys & 0xFFFFFFFF)
    return bits.view(torch.float32), idx.to(torch.int32)


TILE, ITEMS = 6, 2     # kMergeTile and kMergeItems of select.cuh, cut down


def _merge_split(a: list, b: list, d: int) -> int:
    """select.cuh's merge_split: how many of the first d keys of the
    merge of a and b (both descending) come from a."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] > b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _merge_pair(a: list, b: list, k: int) -> list:
    """merge_runs_kernel's order of work on one pair of sorted runs: the
    top min(k, both) outputs in tiles of TILE cut by two merge splits,
    each tile's stretches of a and b staged, each thread's ITEMS outputs
    merged from its own split of the staged stretches."""
    n_out = min(k, len(a) + len(b))
    out = []
    for d0 in range(0, n_out, TILE):
        d1 = min(d0 + TILE, n_out)
        i0, i1 = _merge_split(a, b, d0), _merge_split(a, b, d1)
        sa, sb = a[i0:i1], b[d0 - i0:d1 - i1]
        for lo in range(0, d1 - d0, ITEMS):
            i = _merge_split(sa, sb, lo)
            j = lo - i
            for _ in range(lo, min(lo + ITEMS, d1 - d0)):
                if j >= len(sb) or (i < len(sa) and sa[i] > sb[j]):
                    out.append(sa[i])
                    i += 1
                else:
                    out.append(sb[j])
                    j += 1
    return out


def _split_topk(keys: torch.Tensor, k: int, chunk: int) -> torch.Tensor:
    """The kernels' order of work: the top-min(k, len) keys of every chunk,
    sorted. While 2k <= chunk, the survivors laid end to end chunk by
    chunk are split again until one chunk holds the row (the order inside
    a chunk does not matter there), then the row's top-k in descending
    order. Above, the chunks' sorted runs are merged pairwise, a lone last
    run carried over, each merge keeping the top min(k, both), until one
    run is left."""
    if keys.shape[1] <= chunk:
        return keys.topk(k, dim=1).values
    runs = [part.topk(min(k, part.shape[1]), dim=1).values
            for part in keys.split(chunk, dim=1)]
    if 2 * k <= chunk:
        keys = torch.cat(runs, dim=1)
        while keys.shape[1] > chunk:
            keys = torch.cat([part.topk(min(k, part.shape[1]), dim=1).values
                              for part in keys.split(chunk, dim=1)], dim=1)
        return keys.topk(k, dim=1).values
    rows = []
    for r in range(keys.shape[0]):
        level = [run[r].tolist() for run in runs]
        while len(level) > 1:
            level = [_merge_pair(level[i], level[i + 1] if i + 1 < len(level)
                                 else [], k)
                     for i in range(0, len(level), 2)]
        rows.append(level[0])
    return torch.tensor(rows, dtype=torch.int64)


def _model_topk(scores: torch.Tensor, k: int, chunk: int, signed: bool):
    vals, idxs = _unkey(_split_topk(_keys(scores, not signed), k, chunk))
    if not signed:
        # the value written is the maximum of the entries still alive: a
        # zero is +0.0 while some +0.0 lies at its index or after it
        pos = (scores.contiguous().view(torch.int32) == 0)
        ar = torch.arange(scores.shape[1], dtype=torch.int32)
        last = torch.where(pos, ar, -1).amax(dim=1, keepdim=True)
        vals = torch.where((vals == 0) & (last < idxs), -0.0, vals)
    return vals, idxs


def _model_fused(lut, codes, ids, valid, bias, k: int, chunk: int):
    scores = torch.where(valid, pq_score_seq_ref(lut, codes) + bias,
                         float("-inf"))
    vals, idxs = _unkey(_split_topk(_keys(scores, False), k, chunk))
    sel_id = torch.gather(ids, 1, idxs.long())
    sel_ok = torch.gather(valid, 1, idxs.long())
    dup = torch.zeros_like(sel_ok)
    for r in range(k):                      # one check per entry
        same = sel_ok[:, :r] & (sel_id[:, :r] == sel_id[:, r:r + 1])
        dup[:, r] = sel_ok[:, r] & same.any(dim=1)
    return torch.where(dup, float("-inf"), vals), idxs


def _topk_split_inputs():
    rows = cases.signed_zero_rows()
    return cases.topk_split_cases(32) + [("signed zeros", rows, 16),
                                         ("signed zeros k>64", rows, 70)]


@pytest.mark.parametrize("name", ["equal values", "ragged zeros",
                                  "signed zeros", "signed zeros k>64"])
def test_split_topk_model_is_exact(name):
    """The split top-k equals the plain version and the reference in both
    orders (the reference's routing: Pallas body at k <= 64, lax.top_k
    above) at every chunk size."""
    scores, k = {n: (s, k) for n, s, k in _topk_split_inputs()}[name]
    signed = k > 64
    want = jops.topk_select(jnp.asarray(scores), k, interpret=True)
    plain = topk_select.topk_select_plain(torch.as_tensor(scores), k,
                                          signed_zeros=signed)
    _assert_bitwise((plain[0].numpy(), plain[1].numpy()), want)
    for chunk in CHUNKS:
        got = _model_topk(torch.as_tensor(scores), k, chunk, signed)
        _assert_bitwise((got[0].numpy(), got[1].numpy()), want)
    if name == "equal values":
        assert plain[1][0].tolist() == list(range(k))


def _fused_split_inputs():
    """The split cases of kernels/cases.py at a 32-candidate chunk, plus
    a tie-heavy row with duplicate ids at test_torch_kernels.py's shape."""
    rng = np.random.default_rng(13)
    out = cases.fused_query_split_cases(rng, 32)
    out.append(("ties+dups", cases.fused_query_inputs(
        rng, 3, 160, 4, 24, 5, 0.4, ties=True), 53))
    return out


@pytest.mark.parametrize("name", ["ragged chunk", "short row k=N",
                                  "copies across chunks", "all-invalid long",
                                  "ties+dups"])
def test_split_fused_model_is_exact(name):
    """Chunked top-k, merge and the parallel dedup-after-cut equal
    ``fused_query_plain`` and the reference's fused shortlist (its Pallas
    kernel in interpret mode) at every chunk size."""
    inputs, k = {n: (c, k) for n, c, k in _fused_split_inputs()}[name]
    args = [torch.as_tensor(inputs[a]) for a in cases.FQ_ORDER]
    want = jops.pq_score_dedup_topk(
        jnp.asarray(inputs["lut"]), jnp.asarray(inputs["codes"]),
        jnp.asarray(inputs["ids"]), k, valid=jnp.asarray(inputs["valid"]),
        bias=jnp.asarray(inputs["bias"]), use_kernel=True, interpret=True)
    plain = fused_query.fused_query_plain(*args, k)
    _assert_bitwise((plain[0].numpy(), plain[1].numpy()), want)
    for chunk in CHUNKS:
        got = _model_fused(*args, k, chunk)
        _assert_bitwise((got[0].numpy(), got[1].numpy()), want)
    if name == "all-invalid long":
        assert (plain[1].numpy() == np.arange(k)).all()
    if name == "copies across chunks":
        finite = torch.isfinite(plain[0])
        for r in range(2):
            picked = args[2][r][plain[1][r].long()][finite[r]]
            assert len(set(picked.tolist())) == int(finite[r].sum())


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("n,k,chunk", [(64, 9, 16), (80, 30, 16),
                                       (49, 26, 16), (257, 40, 32),
                                       (100, 100, 24)])
def test_split_topk_pairwise_merge_is_exact(n, k, chunk, signed):
    """At k > chunk / 2 on rows of several chunks, where the chunks'
    sorted runs are merged pairwise (4 and 5 chunks, a last chunk of one
    entry, 9 chunks, k = N): the model equals ``topk_ref`` (lax.top_k's
    order) and the plain version of the Pallas order, bitwise. Scores
    come from few values with both zeros inside every cut and -inf
    holes, as ``cases.topk_long_k_cases`` draws them for the card."""
    rng = np.random.default_rng(n + k)
    vals = np.asarray([0.5, 0.0, -0.0, -0.25, -np.inf], np.float32)
    scores = rng.choice(vals, (3, n), p=[0.05, 0.3, 0.3, 0.15, 0.2])
    scores[-1, n // 4:] = -np.inf
    scores = torch.as_tensor(scores)
    want = (ref.topk_ref(scores, k) if signed
            else topk_select.topk_select_plain(scores, k))
    got = _model_topk(scores, k, chunk, signed)
    _assert_bitwise((got[0].numpy(), got[1].numpy()),
                    (want[0].numpy(), want[1].numpy()))
    assert (got[0] == 0).any()
