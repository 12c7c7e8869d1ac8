"""Synthetic multimodal datasets with planted cluster structure (numpy-only
copy of ``repro/data/synthetic.py``, so both packages get byte-identical
corpora from one seed).

The paper evaluates on ogbn-arxiv (dense text embedding + publication year)
and ogbn-products (co-purchase id lists + dense PCA embedding);
``OGB_ARXIV_LIKE`` / ``OGB_PRODUCTS_LIKE`` mirror their feature shapes and
statistics at configurable scale. The Android-Security stream waits for
the multi-modal slice of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import FeatureSpec, PAD_ITEM

# ogbn-arxiv's real node count: the corpus size of a full deployment
OGB_ARXIV_NODES = 169_343


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    n_points: int = 10_000
    n_clusters: int = 200
    spec: FeatureSpec = FeatureSpec()
    dense_noise: float = 0.35        # within-cluster noise (unit-norm centers)
    set_vocab_per_cluster: int = 30  # cluster-specific item pool
    set_fill: float = 0.7            # fraction of set slots filled on average
    set_noise: float = 0.15          # probability an item is random (global)
    scalar_spread: float = 2.0       # within-cluster scalar spread
    zipf_clusters: bool = True       # realistic skewed cluster sizes
    seed: int = 0


OGB_ARXIV_LIKE = SyntheticConfig(
    n_points=20_000, n_clusters=40,
    spec=FeatureSpec(dense={"text": 128}, sets={}, scalars=("year",)),
    dense_noise=0.35, scalar_spread=3.0, seed=1)

OGB_PRODUCTS_LIKE = SyntheticConfig(
    n_points=40_000, n_clusters=47,
    spec=FeatureSpec(dense={"bow_pca": 100}, sets={"copurchase": 16},
                     scalars=()),
    dense_noise=0.4, set_vocab_per_cluster=40, seed=2)


def make_dataset(cfg: SyntheticConfig):
    """Returns (ids int64 [N], features dict, cluster int32 [N])."""
    rng = np.random.default_rng(cfg.seed)
    n, c = cfg.n_points, cfg.n_clusters

    if cfg.zipf_clusters:
        probs = 1.0 / np.arange(1, c + 1) ** 0.9
        probs /= probs.sum()
        cluster = rng.choice(c, n, p=probs).astype(np.int32)
    else:
        cluster = rng.integers(0, c, n).astype(np.int32)

    features: dict = {}
    for name, dim in sorted(cfg.spec.dense.items()):
        centers = rng.normal(size=(c, dim))
        centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
        # dense_noise is the *total* noise norm relative to the unit-norm
        # center, so cluster separation is dimension-independent
        sigma = cfg.dense_noise / np.sqrt(dim)
        x = centers[cluster] + sigma * rng.normal(size=(n, dim))
        features[f"dense:{name}"] = x.astype(np.float32)

    for name, cap in sorted(cfg.spec.sets.items()):
        vocab = cfg.set_vocab_per_cluster
        items = np.full((n, cap), PAD_ITEM, np.int32)
        counts = rng.binomial(cap, cfg.set_fill, size=n)
        for i in range(n):
            k = max(int(counts[i]), 1)
            pool = cluster[i] * vocab + rng.integers(0, vocab, k)
            noise = rng.random(k) < cfg.set_noise
            pool[noise] = rng.integers(0, c * vocab, noise.sum())
            items[i, :k] = pool
        features[f"set:{name}"] = items

    for name in sorted(cfg.spec.scalars):
        base = rng.uniform(0, 25, size=c)
        x = base[cluster] + cfg.scalar_spread * rng.normal(size=n)
        features[f"scalar:{name}"] = x.astype(np.float32)

    ids = np.arange(n, dtype=np.int64)
    return ids, features, cluster


def labeled_pairs(features: dict, cluster: np.ndarray, n_pairs: int,
                  spec: FeatureSpec, seed: int = 0):
    """Balanced positive/negative pairs for offline scorer training:
    (pair features f32 [n_pairs, F], labels f32 [n_pairs])."""
    from repro_torch.core.scorer import pair_features  # local: avoids a cycle
    rng = np.random.default_rng(seed)
    n = cluster.shape[0]
    half = n_pairs // 2

    # positives: sample within clusters
    pos_a, pos_b = [], []
    order = np.argsort(cluster)
    sorted_cl = cluster[order]
    starts = np.searchsorted(sorted_cl, np.arange(cluster.max() + 1))
    ends = np.append(starts[1:], n)
    sizes = ends - starts
    eligible = np.nonzero(sizes >= 2)[0]
    choice = rng.choice(eligible, half)
    for cl in choice:
        i, j = rng.choice(sizes[cl], 2, replace=False)
        pos_a.append(order[starts[cl] + i])
        pos_b.append(order[starts[cl] + j])

    neg_a = rng.integers(0, n, half)
    neg_b = rng.integers(0, n, half)
    same = cluster[neg_a] == cluster[neg_b]
    neg_b = np.where(same, (neg_b + rng.integers(1, n, half)) % n, neg_b)

    a = np.concatenate([np.asarray(pos_a), neg_a])
    b = np.concatenate([np.asarray(pos_b), neg_b])
    labels = np.concatenate([np.ones(half), (cluster[a[half:]] ==
                                             cluster[b[half:]]).astype(float)])
    perm = rng.permutation(a.size)
    a, b, labels = a[perm], b[perm], labels[perm]

    fa = {k: v[a] for k, v in features.items()}
    fb = {k: v[b] for k, v in features.items()}
    feats = pair_features(fa, fb, spec, device="cpu").numpy()   # numpy out
    return feats.astype(np.float32), labels.astype(np.float32)
