"""Synthetic multimodal datasets with planted cluster structure (numpy-only
copy of ``repro/data/synthetic.py``, so both packages get byte-identical
corpora from one seed).

The paper evaluates on ogbn-arxiv (dense text embedding + publication year)
and ogbn-products (co-purchase id lists + dense PCA embedding);
``OGB_ARXIV_LIKE`` / ``OGB_PRODUCTS_LIKE`` mirror their feature shapes and
statistics at configurable scale. ``AndroidSecurityStream`` is the
streaming harmful-app scenario of the time-to-flag benchmark
(``benchmarks/torch_time_to_flag.py``); its numpy RNG gives both packages
the same stream and the same scorer training pairs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import (FeatureSpec, MutationBatch, PAD_ITEM,
                                    MUTATION_INSERT, MUTATION_UPDATE)

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


# ------------------------------------------------------------------
# Android-Security streaming scenario (paper §1: "capturing harmful
# applications", the headline multi-modal consumer)

@dataclasses.dataclass(frozen=True)
class AndroidSecurityConfig:
    """A streaming "harmful app" workload: malware *families* share
    sparse signature tokens from the moment they appear, but their dense
    (behavioral) embeddings only converge after the app has been observed
    for a while — the regime where multi-modal retrieval beats
    single-embedding ANN on time-to-flag."""
    n_benign: int = 200          # bootstrap benign corpus
    n_benign_clusters: int = 6
    n_families: int = 4          # malware families
    apps_per_family: int = 4     # streamed harmful apps per family
    seeds_per_family: int = 2    # pre-labeled bad apps in the bootstrap
    converge_after: int = 5      # batches from insert to converged-dense update
    arrivals_per_batch: int = 1  # harmful inserts per mutation batch
    batch_size: int = 8          # rows per mutation batch (benign fill)
    sig_items: int = 10          # signature tokens carried per app
    sig_vocab: int = 12          # per-family signature token pool
    dense_dim: int = 32
    set_cap: int = 16
    dense_noise: float = 0.25
    seed: int = 0

    def spec(self) -> FeatureSpec:
        return FeatureSpec(dense={"emb": self.dense_dim},
                           sets={"sig": self.set_cap}, scalars=())


def _unit_rows(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-9)


class AndroidSecurityStream:
    """Deterministic mutation stream for the Android-Security scenario.

    ``bootstrap()`` yields the benign corpus plus ``seeds_per_family``
    known-bad apps per family (converged dense + family signature
    tokens). ``batches()`` then streams: each harmful app is INSERTed
    with an *unconverged* (random) dense embedding but its family's
    signature tokens, and ``converge_after`` batches later receives an
    UPDATE with the converged dense embedding; benign inserts fill the
    remaining rows. ``arrival_batch`` records when each harmful app
    appeared — the time-to-flag benchmark's clock origin.
    """

    BENIGN_BASE = 0
    SEED_BASE = 100_000
    HARM_BASE = 200_000
    SIG_TOKEN_BASE = 1_000_000   # family tokens disjoint from benign vocab

    def __init__(self, cfg: AndroidSecurityConfig = AndroidSecurityConfig()):
        self.cfg = cfg
        self.spec = cfg.spec()
        self._rng = np.random.default_rng(cfg.seed)
        c = cfg.n_benign_clusters
        self._benign_centers = _unit_rows(
            self._rng.normal(size=(c, cfg.dense_dim)))
        self._family_centers = _unit_rows(
            self._rng.normal(size=(cfg.n_families, cfg.dense_dim)))
        self._next_benign = 0
        self.family_of: dict[int, int] = {}
        self.arrival_batch: dict[int, int] = {}
        self.harmful_ids: list[int] = []
        self.seed_bad_ids: list[int] = []
        self._sig_tokens: dict[int, np.ndarray] = {}

    # ------------------------------------------------------- point makers

    def _benign_point(self, rng) -> tuple:
        cfg = self.cfg
        cl = int(rng.integers(cfg.n_benign_clusters))
        dense = self._benign_centers[cl] + (
            cfg.dense_noise / np.sqrt(cfg.dense_dim)
        ) * rng.normal(size=cfg.dense_dim)
        toks = np.full(cfg.set_cap, PAD_ITEM, np.int32)
        k = cfg.sig_items
        toks[:k] = cl * 50 + rng.integers(0, 50, k)
        return dense.astype(np.float32), toks

    def _family_tokens(self, fam: int, rng) -> np.ndarray:
        cfg = self.cfg
        toks = np.full(cfg.set_cap, PAD_ITEM, np.int32)
        pick = rng.choice(cfg.sig_vocab, cfg.sig_items, replace=False)
        toks[:cfg.sig_items] = (self.SIG_TOKEN_BASE
                                + fam * cfg.sig_vocab + pick).astype(np.int32)
        return toks

    def _family_dense(self, fam: int, rng, converged: bool) -> np.ndarray:
        cfg = self.cfg
        if converged:
            x = self._family_centers[fam] + (
                cfg.dense_noise / np.sqrt(cfg.dense_dim)
            ) * rng.normal(size=cfg.dense_dim)
        else:
            # pre-convergence: the dense view carries no family signal
            x = _unit_rows(rng.normal(size=cfg.dense_dim))
        return x.astype(np.float32)

    # -------------------------------------------------------- the corpus

    def bootstrap(self) -> tuple:
        """(ids int64, features) — benign corpus + pre-labeled bad seeds."""
        cfg = self.cfg
        rng = self._rng
        dense, toks, ids = [], [], []
        for _ in range(cfg.n_benign):
            d, t = self._benign_point(rng)
            dense.append(d)
            toks.append(t)
            ids.append(self.BENIGN_BASE + self._next_benign)
            self._next_benign += 1
        for fam in range(cfg.n_families):
            for s in range(cfg.seeds_per_family):
                pid = self.SEED_BASE + fam * cfg.seeds_per_family + s
                dense.append(self._family_dense(fam, rng, converged=True))
                toks.append(self._family_tokens(fam, rng))
                ids.append(pid)
                self.seed_bad_ids.append(pid)
                self.family_of[pid] = fam
        feats = {"dense:emb": np.stack(dense),
                 "set:sig": np.stack(toks)}
        return np.asarray(ids, np.int64), feats

    def n_batches(self) -> int:
        cfg = self.cfg
        arrivals = cfg.n_families * cfg.apps_per_family
        arrive_span = int(np.ceil(arrivals / cfg.arrivals_per_batch))
        return arrive_span + cfg.converge_after + 2

    def batches(self):
        """Yield the scenario's ``MutationBatch`` stream."""
        cfg = self.cfg
        rng = self._rng
        arrivals = [(fam, a) for fam in range(cfg.n_families)
                    for a in range(cfg.apps_per_family)]
        # interleave families so consecutive arrivals differ
        arrivals.sort(key=lambda t: (t[1], t[0]))
        due_updates: list[tuple[int, int]] = []   # (batch index, pid)
        next_arrival = 0
        for b in range(self.n_batches()):
            ids, kinds, dense, toks = [], [], [], []
            for _ in range(cfg.arrivals_per_batch):
                if next_arrival >= len(arrivals):
                    break
                fam, a = arrivals[next_arrival]
                next_arrival += 1
                pid = self.HARM_BASE + fam * cfg.apps_per_family + a
                self.harmful_ids.append(pid)
                self.family_of[pid] = fam
                self.arrival_batch[pid] = b
                self._sig_tokens[pid] = self._family_tokens(fam, rng)
                ids.append(pid)
                kinds.append(MUTATION_INSERT)
                dense.append(self._family_dense(fam, rng, converged=False))
                toks.append(self._sig_tokens[pid])
                due_updates.append((b + cfg.converge_after, pid))
            while due_updates and due_updates[0][0] <= b:
                _, pid = due_updates.pop(0)
                fam = self.family_of[pid]
                ids.append(pid)
                kinds.append(MUTATION_UPDATE)
                dense.append(self._family_dense(fam, rng, converged=True))
                toks.append(self._sig_tokens[pid])  # tokens are stable
            while len(ids) < cfg.batch_size:
                d, t = self._benign_point(rng)
                ids.append(self.BENIGN_BASE + self._next_benign)
                self._next_benign += 1
                kinds.append(MUTATION_INSERT)
                dense.append(d)
                toks.append(t)
            yield MutationBatch(
                ids=np.asarray(ids, np.int64),
                kinds=np.asarray(kinds, np.int32),
                features={"dense:emb": np.stack(dense),
                          "set:sig": np.stack(toks)})

    # ------------------------------------------------------ scorer labels

    def training_pairs(self, n_pairs: int = 2000, seed: int = 123) -> tuple:
        """Balanced labeled pairs for offline scorer training, including
        the scenario's key positives: same-family pairs where one side's
        dense embedding has *not* converged (labels come from the known
        malware families, so the scorer learns that shared signature
        tokens imply similarity even when the dense views disagree)."""
        from repro_torch.core.scorer import pair_features  # local: a cycle
        cfg = self.cfg
        rng = np.random.default_rng(seed)

        def sample():
            """A random point with its group key (for negative pairing)."""
            if rng.random() < 0.5:
                cl = int(rng.integers(cfg.n_benign_clusters))
                dense = self._benign_centers[cl] + (
                    cfg.dense_noise / np.sqrt(cfg.dense_dim)
                ) * rng.normal(size=cfg.dense_dim)
                toks = np.full(cfg.set_cap, PAD_ITEM, np.int32)
                toks[:cfg.sig_items] = cl * 50 + rng.integers(
                    0, 50, cfg.sig_items)
                return ("benign", cl), (dense.astype(np.float32), toks)
            fam = int(rng.integers(cfg.n_families))
            conv = bool(rng.random() < 0.5)
            return ("family", fam), (self._family_dense(fam, rng, conv),
                                     self._family_tokens(fam, rng))

        half = n_pairs // 2
        fa_d, fa_t, fb_d, fb_t, labels = [], [], [], [], []
        for i in range(n_pairs):
            pos = i < half
            if pos:
                if rng.random() < 0.5:
                    cl = int(rng.integers(cfg.n_benign_clusters))
                    rows = []
                    for _ in range(2):
                        dense = self._benign_centers[cl] + (
                            cfg.dense_noise / np.sqrt(cfg.dense_dim)
                        ) * rng.normal(size=cfg.dense_dim)
                        toks = np.full(cfg.set_cap, PAD_ITEM, np.int32)
                        toks[:cfg.sig_items] = cl * 50 + rng.integers(
                            0, 50, cfg.sig_items)
                        rows.append((dense.astype(np.float32), toks))
                else:
                    fam = int(rng.integers(cfg.n_families))
                    rows = [(self._family_dense(
                        fam, rng, bool(rng.random() < 0.5)),
                        self._family_tokens(fam, rng)) for _ in range(2)]
            else:
                key_a, a = sample()
                key_b, b = sample()
                while key_b == key_a:    # a true negative crosses groups
                    key_b, b = sample()
                rows = [a, b]
            fa_d.append(rows[0][0])
            fa_t.append(rows[0][1])
            fb_d.append(rows[1][0])
            fb_t.append(rows[1][1])
            labels.append(1.0 if pos else 0.0)
        fa = {"dense:emb": np.stack(fa_d), "set:sig": np.stack(fa_t)}
        fb = {"dense:emb": np.stack(fb_d), "set:sig": np.stack(fb_t)}
        feats = pair_features(fa, fb, self.spec, device="cpu").numpy()
        return feats.astype(np.float32), np.asarray(labels, np.float32)
