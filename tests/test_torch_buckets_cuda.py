"""The bucket-column kernels (``kernels/csrc/buckets.cu``) against their
plain versions, bitwise, on the card: ids and valid flags from the same
projections, set items and scalars, for arxiv's schema, products' and a
schema with two modes of every kind, from 1 to 1,469,417 rows (the
products bootstrap's). Whether there is a card is decided in the ``card``
fixture, so without one every test here skips. Run on the H100 with

    python -m pytest -q -m cuda tests/test_torch_buckets_cuda.py

This file imports no jax; ``tests/test_torch_bucket_columns.py`` holds the
kernels' arithmetic against the reference on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.buckets import (BucketConfig, generate_buckets,
                                      make_bucket_params)
from repro_torch.core.types import FeatureSpec
from repro_torch.kernels import buckets as kb
from repro_torch.kernels import cases, ops

pytestmark = pytest.mark.cuda

SCHEMAS = {
    "arxiv": (FeatureSpec(dense={"text": 128}, scalars=("year",)),
              BucketConfig(8, 10, 6, (2.0,))),
    "products": (FeatureSpec(dense={"bow_pca": 100},
                             sets={"copurchase": 16}),
                 BucketConfig(8, 10, 6, (2.0,))),
    # two dense widths, two set caps, two scalars at two widths; more
    # MinHash tables than one pass over a row's items takes; a seed whose
    # seed * 131 passes 32 bits
    "mixed": (FeatureSpec(dense={"b": 40, "a": 24}, sets={"t": 11, "s": 5},
                          scalars=("y", "x")),
              BucketConfig(5, 12, 10, (0.25, 3.0), seed=3_000_031_301)),
}
SENTINEL = -7


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _outputs(spec, cfg, rows: int, dev):
    ids = torch.full((rows, cfg.k_max(spec)), SENTINEL, dtype=torch.int64,
                     device=dev)
    return ids, torch.zeros(ids.shape, dtype=torch.bool, device=dev)


def _columns(inputs: dict, spec, cfg, rows: int, dev, to=None):
    """Both wrappers on ``dev``, one after the other: the outputs after
    the SimHash and scalar columns, then after the set tables."""
    to = to or (lambda a: torch.as_tensor(a).to(dev))
    ids, valid = _outputs(spec, cfg, rows, dev)
    kb.simhash_scalar_columns([to(p) for p in inputs["projections"]],
                              [to(x) for x in inputs["scalars"]], spec, cfg,
                              ids, valid)
    first = (ids.cpu().clone(), valid.cpu().clone())
    kb.minhash_columns([to(s) for s in inputs["sets"]], spec, cfg, ids,
                       valid)
    return first, (ids.cpu(), valid.cpu())


def _assert_same(got, want):
    for (g_ids, g_valid), (w_ids, w_valid) in zip(got, want):
        assert torch.equal(g_ids, w_ids)
        assert torch.equal(g_valid, w_valid)


@pytest.mark.parametrize("schema,rows", [
    (schema, rows) for schema in sorted(SCHEMAS)
    for rows in (1, 16, 1024, 100_003)] + [("products", 1_469_417)])
def test_columns_match_plain_bitwise(card, schema, rows):
    """Each wrapper's columns equal its plain version's bit for bit, and
    neither writes a column of the other's (the sentinel stays until its
    owner runs). 100,003 rows fill no whole block; 1,469,417 are the
    products bootstrap's."""
    spec, cfg = SCHEMAS[schema]
    inputs = cases.bucket_inputs(np.random.default_rng(rows), spec, cfg,
                                 rows)
    before = dict(ops.launch_counts())
    got = _columns(inputs, spec, cfg, rows, card)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["simhash_scalar_columns"] == \
        before["simhash_scalar_columns"] + 1
    assert counts["minhash_columns"] == \
        before["minhash_columns"] + bool(spec.sets)
    want = _columns(inputs, spec, cfg, rows, torch.device("cpu"))
    _assert_same(got, want)
    ids, valid = got[1]
    assert (ids >= 0).all() and (ids <= 0xFFFFFFFF).all()
    if spec.sets and rows > 5:               # the all-PAD rows are invalid
        assert not valid[5].all() and valid.any()


def test_strided_inputs(card):
    """Projections as a permuted view (as an einsum may return them), set
    items as a column slice of a wider array and scalars as a strided
    slice: read through their strides, bitwise."""
    spec, cfg = SCHEMAS["mixed"]
    rows = 333
    inputs = cases.bucket_inputs(np.random.default_rng(3), spec, cfg, rows)

    def strided(a, dev):
        t = torch.as_tensor(a)
        if t.dim() == 3:                              # [T, B, K] as [B, T, K]
            return t.transpose(0, 1).contiguous().to(dev).transpose(0, 1)
        if t.dim() == 2:                              # the last columns
            wide = torch.full((t.shape[0], t.shape[1] + 3), 5,
                              dtype=t.dtype)
            wide[:, 3:] = t
            return wide.to(dev)[:, 3:]
        return torch.stack([t, -t], 1).to(dev)[:, 0]  # stride 2

    got = _columns(inputs, spec, cfg, rows, card,
                   lambda a: strided(a, card))
    want = _columns(inputs, spec, cfg, rows, torch.device("cpu"))
    _assert_same(got, want)


@pytest.mark.parametrize("schema,minhash", [("arxiv", 0), ("products", 1),
                                            ("mixed", 1)])
def test_generate_buckets_launches(card, schema, minhash):
    """One ``generate_buckets`` call launches ``simhash_scalar_columns``
    once, ``minhash_columns`` once with a set mode and never without, and
    no other kernel of the port; its columns are the plain version's
    from the same projection."""
    spec, cfg = SCHEMAS[schema]
    params = make_bucket_params(spec, cfg, card)
    feats = {k: torch.as_tensor(v).to(card) for k, v in
             cases.feature_rows(np.random.default_rng(1), spec, 16).items()}
    before = dict(ops.launch_counts())
    ids, valid = generate_buckets(feats, spec, cfg, params)
    torch.cuda.synchronize()
    added = {n: c - before[n] for n, c in ops.launch_counts().items()}
    assert added == {n: 0 for n in added} | {
        "simhash_scalar_columns": 1, "minhash_columns": minhash}

    inputs = dict(
        projections=[torch.einsum("bd,tdk->tbk", feats[f"dense:{n}"],
                                  params[f"hyperplanes:{n}"]).cpu()
                     for n in sorted(spec.dense)],
        sets=[feats[f"set:{n}"].cpu() for n in sorted(spec.sets)],
        scalars=[feats[f"scalar:{n}"].cpu() for n in sorted(spec.scalars)])
    _, want = _columns(inputs, spec, cfg, 16, torch.device("cpu"))
    _assert_same([(ids.cpu(), valid.cpu())], [want])


def test_refuses_what_the_kernels_do_not_take(card):
    """int64 set items and a projection of the wrong shape raise before
    any launch."""
    spec, cfg = SCHEMAS["products"]
    ids, valid = _outputs(spec, cfg, 4, card)
    with pytest.raises(ValueError, match="minhash_columns"):
        kb.minhash_columns([torch.zeros((4, 16), dtype=torch.int64,
                                        device=card)], spec, cfg, ids, valid)
    with pytest.raises(ValueError, match="simhash_scalar_columns"):
        kb.simhash_scalar_columns([torch.zeros((8, 4, 12), device=card)], [],
                                  spec, cfg, ids, valid)
