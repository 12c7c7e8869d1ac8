"""The CountSketch kernel's arithmetic (``kernels/csrc/sketch.cu``),
written out in numpy uint32, and the port's plain wrapper
(``kernels/sketch.py``) against the reference's ``count_sketch`` on the
CPU, bitwise: the bucket ``uhash(seed, x) % d_proj``, the sign from
``uhash(seed + 1, x)``, the padding rule, and each coordinate summed in
column order from +0.0 (sign bits compared: numpy calls -0.0 equal to
+0.0). ``tests/test_torch_sketch_cuda.py`` holds the kernel to the plain
version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann.sparse import count_sketch as j_count_sketch
from repro.core.types import SparseBatch as JSparseBatch
from repro_torch.ann import sparse
from repro_torch.core import hashing
from repro_torch.core.types import PAD_INDEX, SparseBatch
from repro_torch.kernels import cases, ops, sketch

GOLDEN = np.uint32(0x9E3779B9)
SEEDS = (7, 13)


def _fmix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _uhash(seed: int, ids: np.ndarray) -> np.ndarray:
    """The kernel's uhash: (uint32)x * golden ^ fmix32(seed), mixed."""
    mix = _fmix32(np.asarray([seed & 0xFFFFFFFF], np.uint32))
    return _fmix32((ids & 0xFFFFFFFF).astype(np.uint32) * GOLDEN ^ mix)


def _model(indices, values, d_proj: int, seed: int) -> np.ndarray:
    """The kernel's sketch in numpy: bucket, sign, the padding test on the
    int64 as the plain version makes it, then the terms in column order."""
    h = _uhash(seed, indices) % np.uint32(d_proj)
    sign = np.where(_uhash(seed + 1, indices) & 1, np.float32(1.0),
                    np.float32(-1.0))
    terms = np.where(indices == PAD_INDEX, np.float32(0.0), values * sign)
    out = np.zeros((indices.shape[0], d_proj), np.float32)
    rows = np.arange(indices.shape[0])
    for k in range(indices.shape[1]):
        out[rows, h[:, k]] += terms[:, k]
    return out


def _plain(indices, values, d_proj: int, seed: int) -> np.ndarray:
    return sketch.count_sketch(torch.as_tensor(indices),
                               torch.as_tensor(values), d_proj, seed).numpy()


def _reference(indices, values, d_proj: int, seed: int) -> np.ndarray:
    sp = JSparseBatch(jnp.asarray(indices.astype(np.uint32)),
                      jnp.asarray(values))
    return np.asarray(j_count_sketch(sp, d_proj, seed))


def _assert_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _wild_ids(rng, shape) -> np.ndarray:
    """int64 ids past uint32: negatives, values at and above 2**32, the
    int64 limits and ``PAD_INDEX``."""
    ids = rng.integers(-2 ** 40, 2 ** 40, shape, dtype=np.int64)
    ids[::2] = rng.integers(0, 2 ** 32, ids[::2].shape, dtype=np.int64)
    flat = ids.reshape(-1)
    flat[rng.random(flat.size) < 0.2] = PAD_INDEX
    special = [0, 1, -1, PAD_INDEX, 2 ** 32, 2 ** 32 + 5,
               PAD_INDEX + 2 ** 32, -2 ** 31, 2 ** 63 - 1, -2 ** 63]
    flat[: len(special)] = special
    return ids


@pytest.mark.parametrize("seed", (*SEEDS, 2 ** 32 - 1))
def test_model_hash_matches_uhash(seed):
    """The model's bucket and sign are ``hashing.uhash``'s on any int64
    (negatives and values past 32 bits wrap, as the kernel's cast does),
    and its sketch is the plain wrapper's bit for bit, ``PAD_INDEX``
    terms zero and ids that only wrap to it not. Seed 2**32 - 1 makes
    seed + 1 wrap to 0."""
    rng = np.random.default_rng(seed % 1000)
    ids = _wild_ids(rng, (61, 17))
    want = hashing.uhash(seed, torch.as_tensor(ids)).numpy()
    np.testing.assert_array_equal(_uhash(seed, ids).astype(np.int64), want)
    np.testing.assert_array_equal(
        _uhash(seed + 1, ids) & 1,
        (hashing.uhash(seed + 1, torch.as_tensor(ids)) & 1).numpy())
    values = rng.standard_normal(ids.shape, dtype=np.float32)
    for d_proj in (16, 64, 509):
        _assert_bits(_plain(ids, values, d_proj, seed),
                     _model(ids, values, d_proj, seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", (1, 9, 14, 40))
@pytest.mark.parametrize("d_proj", (16, 32, 64, 512))
def test_plain_matches_reference(d_proj, k, seed):
    """The plain wrapper and the numpy model equal the reference's
    scatter-add bit for bit: K = 9 is arxiv's columns, 14 products', 40
    more than a warp's lanes; d_proj 64 the cells', 512 the widest the
    repo uses."""
    indices, values = cases.sketch_inputs(np.random.default_rng(k * d_proj),
                                          37, k)
    want = _reference(indices, values, d_proj, seed)
    _assert_bits(_plain(indices, values, d_proj, seed), want)
    _assert_bits(_model(indices, values, d_proj, seed), want)


@pytest.mark.parametrize("name", [c[0] for c in cases.sketch_edge_cases()])
def test_edge_cases(name):
    """Repeated indices summed in column order, exact cancellation to
    +0.0, -0.0 and NaN at padding (a term of +0.0, which leaves a
    coordinate as it is, since none is ever -0.0) and no rows: the plain
    wrapper equals the reference and the model bit for bit, and no
    coordinate is -0.0."""
    _, indices, values = dict((c[0], c) for c in
                              cases.sketch_edge_cases())[name]
    for d_proj in (16, 64):
        got = _plain(indices, values, d_proj, 7)
        _assert_bits(got, _reference(indices, values, d_proj, 7))
        _assert_bits(got, _model(indices, values, d_proj, 7))
        assert not (got.view(np.int32) == np.int32(-2 ** 31)).any()
        assert np.isfinite(got).all()
    if name == "order":       # column order leaves 0.0; the reverse, +-1.0
        assert not _plain(indices, values, 64, 7).any()
        assert _model(indices[:, ::-1], values[:, ::-1], 64, 7).any()
    if name == "empty":
        assert got.shape == (0, 64)


def test_sparse_count_sketch_takes_the_wrapper(monkeypatch):
    """``ann.sparse.count_sketch`` on the CPU runs the wrapper's plain
    version, once a call, and launches no kernel."""
    indices, values = cases.sketch_inputs(np.random.default_rng(3), 16, 9)
    calls = []
    plain = sketch.count_sketch_plain

    def spy(*args):
        calls.append(args[2:])
        return plain(*args)

    monkeypatch.setattr(sketch, "count_sketch_plain", spy)
    before = ops.launch_counts()["count_sketch"]
    got = sparse.count_sketch(SparseBatch(torch.as_tensor(indices),
                                          torch.as_tensor(values)), 64, 13)
    assert calls == [(64, 13)]
    assert ops.launch_counts()["count_sketch"] == before
    _assert_bits(got.numpy(), _reference(indices, values, 64, 13))


@pytest.mark.parametrize("what", ("int32 indices", "float64 values", "rank",
                                  "shapes", "d_proj 0"))
def test_refusals(what):
    """Inputs outside the contract raise on the CPU too."""
    idx = torch.zeros((4, 9), dtype=torch.int64)
    val = torch.zeros((4, 9), dtype=torch.float32)
    d_proj = 64
    if what == "int32 indices":
        idx = idx.to(torch.int32)
    elif what == "float64 values":
        val = val.to(torch.float64)
    elif what == "rank":
        idx, val = idx[0], val[0]
    elif what == "shapes":
        val = val[:, :8]
    else:
        d_proj = 0
    with pytest.raises(ValueError, match="count_sketch"):
        sketch.count_sketch(idx, val, d_proj, 7)
