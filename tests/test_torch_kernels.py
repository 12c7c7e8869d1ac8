"""The plain versions of the port's kernels against the reference's
oracles, on the CPU (the CUDA kernels themselves are held against these
plain versions on the card: tests/test_torch_kernels_cuda.py).

Tolerances: the fused shortlist and the stable top-k are bitwise (values,
-inf placement, tie order); ``sparse_dot`` is bitwise at unit weights
(sums of exact products) and within rtol/atol 1e-6 with IDF-like weights
(another summation order); ``scorer_mlp`` within rtol/atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypo_compat import given, settings, st
from repro.core.scorer import scorer_apply as j_scorer_apply
from repro.kernels import ref as jref
from repro.kernels.fused_query import fused_query_xla
from repro.kernels.sparse_dot import sparse_dot as j_sparse_dot
from repro.kernels.sparse_dot import sparse_dot_batched as j_sparse_dot_batched
from repro_torch.core.scorer import scorer_apply
from repro_torch.kernels import fused_query, ops, ref

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


def _fq_both(lut, codes, ids, k, valid, bias):
    """Port entry point vs the reference's XLA twin and composed oracle."""
    got = ops.pq_score_dedup_topk(
        torch.as_tensor(lut), torch.as_tensor(codes), torch.as_tensor(ids), k,
        valid=torch.as_tensor(valid), bias=torch.as_tensor(bias))
    ids_i32 = ids.astype(np.int64).astype(np.int32)
    for want in (fused_query_xla(jnp.asarray(lut), jnp.asarray(codes),
                                 jnp.asarray(ids_i32), jnp.asarray(valid),
                                 jnp.asarray(bias), k),
                 jref.fused_query_ref(jnp.asarray(lut), jnp.asarray(codes),
                                      jnp.asarray(ids_i32), k,
                                      valid=jnp.asarray(valid),
                                      bias=jnp.asarray(bias))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    return got


# The reference compiles each (shape, k) once, for about a second: the
# sweep and the edge cases share these shapes and k values (small k, a
# third of n, k = n)
FQ_SHAPES = {(1, 40, 2, 8): (1, 40), (3, 160, 4, 24): (53, 160)}


def _fq_random(rng, shape, id_pool, tomb, ties=True):
    b, n, m, c = shape
    if ties:
        lut = rng.choice(np.asarray([-1.5, -0.25, 0.0, 0.5, 2.0], np.float32),
                         size=(b, m, c))
        bias = rng.choice(np.asarray([0.0, 0.75], np.float32), size=(b, n))
    else:
        lut = rng.normal(size=(b, m, c)).astype(np.float32)
        bias = np.zeros((b, n), np.float32)
    return (lut, rng.integers(0, c, (b, n, m)).astype(np.uint8),
            rng.integers(0, id_pool, (b, n)).astype(np.int32),
            rng.random((b, n)) >= tomb, bias)


@settings(max_examples=12, deadline=None)
@given(st.data())
def test_fused_plain_matches_reference_bitwise(data):
    """The randomized sweep of tests/test_kernels_fused.py: SOAR duplicate
    ids, tombstones, score ties, small and full k."""
    shape = sorted(FQ_SHAPES)[data.draw(st.integers(0, 1))]
    n = shape[1]
    k = FQ_SHAPES[shape][data.draw(st.integers(0, 1))]
    id_pool = data.draw(st.integers(2, max(2, n)))
    tomb = data.draw(st.floats(0.0, 0.9))
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 31 - 1)))
    lut, codes, ids, valid, bias = _fq_random(rng, shape, id_pool, tomb)
    _fq_both(lut, codes, ids, k, valid, bias)


def test_fused_plain_uint32_wraparound_ids():
    rng = np.random.default_rng(5)
    lut, codes, ids, valid, bias = _fq_random(rng, (3, 160, 4, 24), 8, 0.3,
                                              ties=False)
    ids = ids.astype(np.uint32) + np.uint32(0xFFFFFF00)
    _fq_both(lut, codes, ids.astype(np.int64), 53, valid, bias)


def test_fused_plain_edge_cases():
    rng = np.random.default_rng(3)
    zeros = np.zeros((1, 40), np.float32)
    # all-tombstone rows: -inf values, indices 0..k-1
    lut, codes, ids, _, bias = _fq_random(rng, (3, 160, 4, 24), 10, 0.0)
    vals, idxs = _fq_both(lut, codes, ids, 160, np.zeros((3, 160), bool),
                          bias)
    assert torch.isneginf(vals).all()
    assert (idxs.numpy() == np.arange(160)).all()
    # k == n: a full permutation
    valid = rng.random((3, 160)) > 0.4
    _, idxs = _fq_both(lut, codes, ids, 160, valid, bias)
    for row in idxs.numpy():
        assert sorted(row.tolist()) == list(range(160))
    # k = the number of live rows, every live id duplicated, dead tail:
    # one copy per live id survives
    lut, codes, _, _, bias = _fq_random(rng, (3, 160, 4, 24), 2, 0.0,
                                        ties=False)
    ids = np.tile(np.arange(160) // 2, (3, 1)).astype(np.int32)
    valid = np.tile(np.arange(160) < 53, (3, 1))
    vals, idxs = _fq_both(lut, codes, ids, 53, valid, bias)
    for r in range(3):
        finite = torch.isfinite(vals[r]).numpy()
        assert sorted(ids[r][idxs[r].numpy()[finite]].tolist()) == list(
            range(27))
        assert sorted(idxs[r].tolist()) == list(range(53))
    # uniform scores: candidate order, later same-id copies -inf
    ids = (np.arange(40)[::-1] // 3)[None].astype(np.int32)
    vals, idxs = _fq_both(np.ones((1, 2, 8), np.float32),
                          np.zeros((1, 40, 2), np.uint8), ids, 40,
                          np.ones((1, 40), bool), zeros)
    assert (idxs[0].numpy() == np.arange(40)).all()
    first = [i == 0 or ids[0, i] != ids[0, i - 1] for i in range(40)]
    assert torch.isfinite(vals[0]).tolist() == first


def test_fused_plain_rejects_unported_int8():
    """``quantized=True`` runs the int8 shortlist: on a table that int8
    holds exactly (integers, amax 127, so every scale is 1) it answers
    bitwise as the f32 shortlist, and the table's dtype is checked. (The
    name is kept from when the int8 shortlist was not yet ported.)"""
    rng = np.random.default_rng(9)
    lut, codes, ids, valid, bias = _fq_random(rng, (3, 160, 4, 24), 20, 0.3)
    lut = np.round(lut * 20).astype(np.float32)
    lut[:, :, 0] = 127.0
    args = [torch.as_tensor(a) for a in (lut, codes, ids)]
    kw = dict(valid=torch.as_tensor(valid), bias=torch.as_tensor(bias))
    got = ops.pq_score_dedup_topk(*args, 53, quantized=True, **kw)
    want = ops.pq_score_dedup_topk(*args, 53, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(TypeError, match="lut must be"):
        fused_query.fused_query_kernel_int8(
            args[0], torch.ones(3, 4), args[1], args[2], kw["valid"],
            kw["bias"], 53)


def test_stable_topk_matches_lax_top_k():
    rng = np.random.default_rng(0)
    scores = rng.choice(np.asarray([-np.inf, -1.0, 0.0, 3.0], np.float32),
                        size=(8, 50))
    scores[0] = -np.inf
    scores[1, :5] = [1, 3, 3, -np.inf, 3]
    for k in (1, 5, 50):
        want = jax.lax.top_k(jnp.asarray(scores), k)
        got = ref.topk_ref(torch.as_tensor(scores), k)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _sparse(rng, shape, vocab, unit):
    idx = np.sort(rng.integers(0, vocab, shape), axis=-1).astype(np.uint32)
    pad = rng.random(shape) < 0.2
    idx = np.sort(np.where(pad, np.uint32(0xFFFFFFFF), idx), axis=-1)
    val = (np.ones(shape, np.float32) if unit
           else (rng.random(shape) * 3 + 0.1).astype(np.float32))
    val = np.where(idx == 0xFFFFFFFF, 0.0, val).astype(np.float32)
    return idx, val


@pytest.mark.parametrize("unit", [True, False])
def test_sparse_dot_plain_matches_reference(unit):
    """Both forms (per-query rows and a shared db) against the reference
    kernels run as its own tests run them (interpret mode)."""
    rng = np.random.default_rng(int(unit))
    qi, qv = _sparse(rng, (6, 9), 30, unit)
    bi, bv = _sparse(rng, (6, 40, 9), 30, unit)
    di, dv = _sparse(rng, (77, 9), 30, unit)
    tq = (torch.as_tensor(qi.astype(np.int64)), torch.as_tensor(qv))
    got_b = ops.sparse_dot_batched(*tq, torch.as_tensor(bi.astype(np.int64)),
                                   torch.as_tensor(bv)).numpy()
    got_s = ops.sparse_dot(*tq, torch.as_tensor(di.astype(np.int64)),
                           torch.as_tensor(dv)).numpy()
    want_b = np.asarray(j_sparse_dot_batched(qi, qv, bi, bv, interpret=True))
    want_s = np.asarray(j_sparse_dot(qi, qv, di, dv, interpret=True))
    want_r = np.asarray(jref.sparse_dot_ref(qi, qv, di, dv))
    if unit:
        np.testing.assert_array_equal(got_b, want_b)
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_s, want_r)
    else:
        np.testing.assert_allclose(got_b, want_b, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_s, want_r, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,f,h", [(160, 3, 10), (7, 5, 32)])
def test_scorer_mlp_plain_matches_reference(b, f, h):
    rng = np.random.default_rng(b)
    names = ["feats", "w0", "b0", "w1", "b1", "w2", "b2"]
    shapes = [(b, f), (f, h), (h,), (h, h), (h,), (h, 1), (1,)]
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    want = np.asarray(jref.scorer_mlp_ref(*arrays))
    params = {n: torch.as_tensor(a) for n, a in zip(names[1:], arrays[1:])}
    got = ops.scorer_mlp(torch.as_tensor(arrays[0]), params).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the plain MLP of training is the same function
    got = scorer_apply(params, torch.as_tensor(arrays[0])).numpy()
    want = np.asarray(j_scorer_apply(
        {n: jnp.asarray(a) for n, a in zip(names[1:], arrays[1:])}, arrays[0]))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
