"""The multi-feature reference against the program on the CPU, at a tiny
size: two dense modes, a set mode with some rows empty and a scalar give
the same bucket ids, sparse rows, exact dots and (within float32's
rounding) pair scores."""
import numpy as np
import pytest
import torch

from harness import data
from harness.runner import lsh_planes
from references import grale_gus as ref

SPEC = data.Spec(dense=(("bow_pca", 100), ("text", 32)),
                 sets=(("copurchase", 16),), scalars=("year",))
BUCKETS = {"dense_tables": 8, "dense_bits": 10, "set_tables": 6,
           "scalar_widths": [2.0], "idf_size": 0, "filter_percent": 0.0}
EMPTY = 7          # rows 0-6 hold no item


def _corpus(n=400, seed=3):
    ids, feats, cluster = data.make_dataset(data.CorpusConfig(
        n_points=n, n_clusters=8, spec=SPEC, scalar_spread=3.0,
        set_vocab_per_cluster=40, seed=seed))
    feats["set:copurchase"][:EMPTY] = data.PAD_ITEM
    return ids, feats, cluster


def _program_spec():
    from repro_torch.core.types import FeatureSpec
    return FeatureSpec(dense=dict(SPEC.dense), sets=dict(SPEC.sets),
                       scalars=SPEC.scalars)


def _program_embedder(lsh_seed):
    from repro_torch.core.buckets import BucketConfig
    from repro_torch.core.embedding import EmbeddingGenerator
    return EmbeddingGenerator.create(
        _program_spec(), BucketConfig(8, 10, 6, (2.0,), seed=lsh_seed), "cpu")


def _mine(feats, lsh_seed, precision="exact"):
    buckets = {**BUCKETS, "seed": lsh_seed}
    return ref.embed(feats, SPEC, buckets, lsh_planes(SPEC, buckets),
                     torch.device("cpu"), precision)


def test_item_hash_equals_program():
    from repro_torch.core import hashing
    x = np.asarray([0, 1, 39, 1879, 2 ** 31 - 1, -1, -2 ** 31], np.int64)
    for key in (0, 5 * 131 + 3, (2 ** 31 - 1) * 131 + 5):
        np.testing.assert_array_equal(
            ref.item_hash(key, x).astype(np.int64),
            hashing.uhash(key, torch.as_tensor(x)).numpy())


def test_planes_equal_the_programs_for_two_dense_modes():
    from repro_torch.core.buckets import BucketConfig, make_bucket_params
    mine = lsh_planes(SPEC, {**BUCKETS, "seed": 77})
    theirs = make_bucket_params(_program_spec(),
                                BucketConfig(8, 10, 6, (2.0,), seed=77), "cpu")
    for name, _dim in SPEC.dense:
        assert torch.equal(mine[name], theirs[f"hyperplanes:{name}"])


@pytest.mark.parametrize("lsh_seed", [1234567, 2 ** 31 - 1])
def test_embedding_equals_program(lsh_seed):
    _, feats, _ = _corpus()
    mine = _mine(feats, lsh_seed)
    emb = _program_embedder(lsh_seed)(feats)
    want = torch.where(emb.values != 0, emb.indices, ref.PAD_INDEX).numpy()
    np.testing.assert_array_equal(mine, want)
    # an empty set has no MinHash: 2 x 8 SimHash ids and 1 scalar id
    nnz = (mine != ref.PAD_INDEX).sum(1)
    assert np.all(nnz[:EMPTY] <= 17) and np.all(nnz[EMPTY:] > 17)
    # the set tables are keyed by the run's seed
    assert np.mean(np.any(_mine(feats, lsh_seed + 1)[:, :] != mine, 1)) > 0.9
    # the control's bfloat16 planes move some points' buckets
    assert np.any(_mine(feats, lsh_seed, "bf16") != mine)


def test_dots_equal_the_program_brute_index():
    from repro_torch.ann.brute import BruteIndex
    ids, feats, _ = _corpus()
    mine = _mine(feats, 5)
    emb = _program_embedder(5)(feats)
    brute = BruteIndex(emb.k, device="cpu")
    brute.upsert(ids, emb)
    got_ids, got_d = brute.search(emb[:20], 5)
    cnt = ref.dots(torch.as_tensor(mine[:20]), torch.as_tensor(mine)).numpy()
    for r in range(20):
        np.testing.assert_array_equal(-cnt[r, got_ids[r]], got_d[r])
        assert -got_d[r][-1] == np.sort(cnt[r])[::-1][4]
    pair = ref.pair_dots(torch.as_tensor(mine[:20]),
                         torch.as_tensor(mine[got_ids[:, 1]])).numpy()
    np.testing.assert_array_equal(-pair, got_d[:, 1])


def test_pair_score_equals_program():
    """Within 1e-6: the program's float32 features and network against
    float64, a few float32 roundings of values of order 1 through weights
    of order 1 (the dense reference's tolerance)."""
    from repro_torch.core.scorer import score_pairs
    _, feats, cluster = _corpus()
    gen = torch.Generator().manual_seed(0)
    f = 2 * 2 + 2 + 1
    params = {"w0": torch.randn(f, 10, generator=gen),
              "b0": torch.randn(10, generator=gen),
              "w1": torch.randn(10, 10, generator=gen),
              "b1": torch.randn(10, generator=gen),
              "w2": torch.randn(10, 1, generator=gen),
              "b2": torch.randn(1, generator=gen)}
    # every row against one of its own cluster (sets that overlap, with
    # repeated items) and against an empty set
    order = np.argsort(cluster, kind="stable")
    a = np.concatenate([order, order[:EMPTY]])
    b = np.concatenate([np.roll(order, 1), np.arange(EMPTY)])
    fa = {k: torch.as_tensor(v[a]) for k, v in feats.items()}
    fb = {k: torch.as_tensor(v[b]) for k, v in feats.items()}
    sf = ref.set_features(fa["set:copurchase"], fb["set:copurchase"],
                          torch.float64)
    assert (sf[0] > 0).float().mean() > 0.5
    mine = ref.pair_score(params, fa, fb, SPEC).numpy()
    want = score_pairs(params, fa, fb, _program_spec()).numpy()
    np.testing.assert_allclose(mine, want, rtol=0, atol=1e-6)
    ctl = ref.pair_score(params, fa, fb, SPEC, "bf16").numpy()
    assert np.max(np.abs(ctl - mine)) > 1e-4
