"""The plain reference against the program on the CPU, at a tiny size:
the same bucket hashes, sparse rows, exact dots and pair scores."""
import numpy as np
import torch

from harness import data
from references import dense_gus as ref

SPEC = data.Spec(dense=(("text", 128),), scalars=("year",))
BUCKETS = {"dense_tables": 8, "dense_bits": 10, "set_tables": 6,
           "scalar_widths": [2.0], "idf_size": 0, "filter_percent": 0.0}


def _corpus(n=400, seed=3):
    return data.make_dataset(data.CorpusConfig(
        n_points=n, n_clusters=8, spec=SPEC, scalar_spread=3.0, seed=seed))


def _program_embedder(lsh_seed):
    from repro_torch.core.buckets import BucketConfig
    from repro_torch.core.embedding import EmbeddingGenerator
    from repro_torch.core.types import FeatureSpec
    spec = FeatureSpec(dense={"text": 128}, scalars=("year",))
    return EmbeddingGenerator.create(
        spec, BucketConfig(8, 10, 6, (2.0,), seed=lsh_seed), "cpu")


def test_hashing_equals_program():
    from repro_torch.core import hashing
    x = np.asarray([0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1, 123456789], np.int64)
    got = ref.hash_fields(3735928559, 5, x)
    want = hashing.hash_fields(3735928559, 5, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.int64), want)
    neg = np.asarray([-1, -7, -2 ** 31], np.int64)
    np.testing.assert_array_equal(
        ref.hash_fields(1, 0, neg).astype(np.int64),
        hashing.hash_fields(1, 0, torch.as_tensor(neg)).numpy())


def test_embedding_equals_program():
    _, feats, _ = _corpus()
    lsh_seed = 1234567
    planes = {"text": ref.hyperplanes(128, 8, 10, lsh_seed)}
    mine = ref.embed(feats, SPEC, BUCKETS, planes, torch.device("cpu"))
    emb = _program_embedder(lsh_seed)(feats)
    want = torch.where(emb.values != 0, emb.indices, ref.PAD_INDEX).numpy()
    np.testing.assert_array_equal(mine, want)
    # the control's bfloat16 planes move some points' buckets
    ctl = ref.embed(feats, SPEC, BUCKETS, planes, torch.device("cpu"), "bf16")
    assert np.any(ctl != mine)


def test_dots_equal_the_program_brute_index():
    from repro_torch.ann.brute import BruteIndex
    ids, feats, _ = _corpus()
    planes = {"text": ref.hyperplanes(128, 8, 10, 5)}
    mine = ref.embed(feats, SPEC, BUCKETS, planes, torch.device("cpu"))
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
    from repro_torch.core.scorer import score_pairs
    from repro_torch.core.types import FeatureSpec
    _, feats, _ = _corpus()
    gen = torch.Generator().manual_seed(0)
    params = {"w0": torch.randn(3, 10, generator=gen), "b0": torch.randn(10, generator=gen),
              "w1": torch.randn(10, 10, generator=gen), "b1": torch.randn(10, generator=gen),
              "w2": torch.randn(10, 1, generator=gen), "b2": torch.randn(1, generator=gen)}
    a = np.arange(0, 200)
    b = np.arange(200, 400)
    fa = {k: torch.as_tensor(v[a]) for k, v in feats.items()}
    fb = {k: torch.as_tensor(v[b]) for k, v in feats.items()}
    mine = ref.pair_score(params, fa, fb, SPEC).numpy()
    want = score_pairs(params, fa, fb, FeatureSpec(dense={"text": 128},
                                                   scalars=("year",))).numpy()
    np.testing.assert_allclose(mine, want, rtol=0, atol=1e-6)
    ctl = ref.pair_score(params, fa, fb, SPEC, "bf16").numpy()
    assert np.max(np.abs(ctl - mine)) > 1e-4
