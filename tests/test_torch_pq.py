"""The port's unfused and int8 shortlists against the reference, on the
CPU: ``pq_score`` / ``pq_score_batched`` (the reference kernels in
interpret mode), ``quantize_lut``, the int8 fused shortlist (the reference
kernel in interpret mode, its XLA twin and its oracle), ``pq_scores`` and
``dedup_mask``, all bitwise; then the scann index with ``fused=False``
equal to the fused index bitwise, and ``pq_int8`` against the reference's
scann at the same trained state (distances within atol 1e-5 / rtol 1e-6,
ids equal except at near-ties of the cut, as in test_torch_gus.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_query as jfq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fused_query, ops

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


def _lut_codes(seed, b=3, n=300, m=4, c=24):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, m, c)).astype(np.float32),
            rng.integers(0, c, (b, n, m)).astype(np.uint8))


@pytest.mark.parametrize("form", ["batched", "shared"])
def test_pq_score_plain_matches_reference_bitwise(form):
    """Both forms against the reference's Pallas kernels (interpret mode,
    one-hot matmuls that add exact zeros) and its ordered oracle."""
    lut, codes = _lut_codes(1)
    if form == "shared":
        codes = codes[0]
        want = np.asarray(jops.pq_score(jnp.asarray(lut), jnp.asarray(codes),
                                        interpret=True))
        got = ops.pq_score(torch.as_tensor(lut), torch.as_tensor(codes))
        oracle = jref.pq_score_seq_ref(jnp.asarray(lut), jnp.broadcast_to(
            jnp.asarray(codes), (3,) + codes.shape))
    else:
        want = np.asarray(jops.pq_score_batched(
            jnp.asarray(lut), jnp.asarray(codes), interpret=True))
        got = ops.pq_score_batched(torch.as_tensor(lut),
                                   torch.as_tensor(codes))
        oracle = jref.pq_score_seq_ref(jnp.asarray(lut), jnp.asarray(codes))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))


def test_quantize_lut_bitwise():
    """Random tables, an all-zero subspace (scale 1) and exact halves
    (round half to even)."""
    rng = np.random.default_rng(2)
    lut = rng.normal(size=(4, 3, 16)).astype(np.float32)
    lut[1, 2] = 0.0
    lut[2, 0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    got = ops.quantize_lut(torch.as_tensor(lut))
    want = jops.quantize_lut(jnp.asarray(lut))
    assert got[0].dtype == torch.int8
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0][2, 0, :6].tolist() == [127, 2, -4, 0, 0, 2]


def test_int8_fused_plain_matches_reference_bitwise():
    """SOAR duplicate ids, tombstones and score ties through the int8
    shortlist: the port against the reference's int8 kernel (interpret
    mode), its XLA twin and its composed oracle."""
    rng = np.random.default_rng(6)
    b, n, m, c, k = 3, 160, 4, 24, 53
    lut = rng.choice(np.asarray([-1.5, -0.25, 0.0, 0.5, 2.0], np.float32),
                     size=(b, m, c)) * rng.random((b, m, 1)).astype(np.float32)
    codes = rng.integers(0, c, (b, n, m)).astype(np.uint8)
    ids = rng.integers(0, 40, (b, n)).astype(np.int32)
    valid = rng.random((b, n)) > 0.3
    bias = rng.choice(np.asarray([0.0, 0.75], np.float32), size=(b, n))
    got = ops.pq_score_dedup_topk(
        torch.as_tensor(lut), torch.as_tensor(codes), torch.as_tensor(ids), k,
        valid=torch.as_tensor(valid), bias=torch.as_tensor(bias),
        quantized=True)
    jl, jc, ji, jv, jb = map(jnp.asarray, (lut, codes, ids, valid, bias))
    qlut, scale = jfq.quantize_lut(jl)
    for want in (jfq.fused_query_kernel_int8(qlut, scale, jc, ji,
                                             jv.astype(jnp.int32), jb, k,
                                             interpret=True),
                 jfq.fused_query_xla(jl, jc, ji, jv, jb, k, quantized=True),
                 jref.fused_query_ref(jl, jc, ji, k, valid=jv, bias=jb,
                                      quantized=True)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the wrapper itself, on the quantised table
    tq, ts = ops.quantize_lut(torch.as_tensor(lut))
    again = fused_query.fused_query_kernel_int8(
        tq, ts, torch.as_tensor(codes), torch.as_tensor(ids),
        torch.as_tensor(valid), torch.as_tensor(bias), k)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.parametrize("quantized", [False, True])
def test_pq_scores_and_dedup_mask_bitwise(quantized):
    """The composed shortlist's pieces: pq_scores (the pq-score kernel's
    plain version, after dequantising for int8) and the dedup mask, against
    the reference's twins."""
    lut, codes = _lut_codes(3, n=160)
    got = ops.pq_scores(torch.as_tensor(lut), torch.as_tensor(codes),
                        quantized=quantized)
    want = jops.pq_scores(jnp.asarray(lut), jnp.asarray(codes),
                          quantized=quantized, use_kernel=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 30, (3, 160)).astype(np.int32)
    valid = rng.random((3, 160)) > 0.3
    scores = np.where(valid, np.asarray(want), -np.inf).astype(np.float32)
    vals, idxs = ops.topk_select(torch.as_tensor(scores), 40)
    got = ops.dedup_mask(vals, idxs, torch.as_tensor(ids),
                         torch.as_tensor(valid))
    jv, ji = jax.lax.top_k(jnp.asarray(scores), 40)
    want = jops.dedup_mask(jv, ji, jnp.asarray(ids), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scann_unfused_and_int8_match():
    """One bootstrapped state in both packages (test_torch_gus._pair): the
    port's index answers bitwise the same with fused=False as fused, for
    the f32 and the int8 table; with pq_int8 it answers as the reference's
    int8 index does."""
    from test_torch_gus import _assert_same_neighbors, _pair

    jg, tg, jstream, tstream = _pair("scann")
    q = jstream.query_features(12)
    emb = tg.embedder(q)
    base = tg.index.cfg
    out = {}
    for fused in (True, False):
        for int8 in (False, True):
            tg.index.cfg = dataclasses.replace(base, fused=fused,
                                               pq_int8=int8)
            out[fused, int8] = tg.index.search(emb, 10)
    for int8 in (False, True):
        for got, want in zip(out[False, int8], out[True, int8]):
            np.testing.assert_array_equal(got, want)
    jg.index.cfg = dataclasses.replace(jg.index.cfg, pq_int8=True)
    tg.index.cfg = dataclasses.replace(base, pq_int8=True)
    diffs = _assert_same_neighbors(jg.neighbors(q, k=10),
                                   tg.neighbors(q, k=10), 10)
    assert diffs <= 0.05 * 12 * 10, diffs
