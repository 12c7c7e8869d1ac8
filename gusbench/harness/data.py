"""The benchmark's own copies of the corpus and mutation-stream generators
(``src/repro_torch/data/synthetic.py`` and ``data/stream.py``), numpy
only, so that the traffic stays where later changes to the program cannot
move it.

``make_dataset`` and ``MutationStream`` draw exactly what the program's
copies draw for the same configuration and seed (``tests/test_gb_data.py``
holds them equal), with two departures: ``make_dataset`` draws set modes
by whole arrays (the program's distribution, not its stream), and
``MutationStream`` takes the corpus it streams over instead of calling
``make_dataset`` a second time.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PAD_ITEM = -1
MUTATION_INSERT, MUTATION_UPDATE, MUTATION_DELETE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Spec:
    """Feature schema: dense mode -> width, set mode -> cap, scalar modes."""
    dense: tuple = ()      # ((name, dim), ...)
    sets: tuple = ()       # ((name, cap), ...)
    scalars: tuple = ()    # (name, ...)

    @staticmethod
    def from_json(d: dict) -> "Spec":
        return Spec(dense=tuple(sorted(d.get("dense", {}).items())),
                    sets=tuple(sorted(d.get("sets", {}).items())),
                    scalars=tuple(d.get("scalars", ())))


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n_points: int
    n_clusters: int
    spec: Spec
    dense_noise: float = 0.35
    set_vocab_per_cluster: int = 30
    set_fill: float = 0.7
    set_noise: float = 0.15
    scalar_spread: float = 2.0
    zipf_clusters: bool = True
    seed: int = 0


def make_dataset(cfg: CorpusConfig):
    """Returns (ids int64 [N], features dict, cluster int32 [N]): the draws
    of ``repro_torch.data.synthetic.make_dataset``, in its order, for the
    clusters and the dense and scalar modes. Set modes are the benchmark's
    own draw (``_draw_set``): the program's distribution, drawn by whole
    arrays instead of row by row, so from the same seed a set mode's items,
    and any scalar mode drawn after one, differ from the program's."""
    rng = np.random.default_rng(cfg.seed)
    n, c = cfg.n_points, cfg.n_clusters
    if cfg.zipf_clusters:
        probs = 1.0 / np.arange(1, c + 1) ** 0.9
        probs /= probs.sum()
        cluster = rng.choice(c, n, p=probs).astype(np.int32)
    else:
        cluster = rng.integers(0, c, n).astype(np.int32)
    features: dict = {}
    for name, dim in sorted(cfg.spec.dense):
        centers = rng.normal(size=(c, dim))
        centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
        sigma = cfg.dense_noise / np.sqrt(dim)
        x = centers[cluster] + sigma * rng.normal(size=(n, dim))
        features[f"dense:{name}"] = x.astype(np.float32)
    for name, cap in sorted(cfg.spec.sets):
        features[f"set:{name}"] = _draw_set(rng, cluster, cap, cfg)
    for name in sorted(cfg.spec.scalars):
        base = rng.uniform(0, 25, size=c)
        x = base[cluster] + cfg.scalar_spread * rng.normal(size=n)
        features[f"scalar:{name}"] = x.astype(np.float32)
    return np.arange(n, dtype=np.int64), features, cluster


def _draw_set(rng: np.random.Generator, cluster: np.ndarray, cap: int,
              cfg: CorpusConfig) -> np.ndarray:
    """One set mode's items int32 [N, cap], by whole arrays: each row holds
    max(binomial(cap, set_fill), 1) items, then ``PAD_ITEM``; an item is
    drawn uniformly from the row's cluster pool of
    ``set_vocab_per_cluster`` ids, and with probability ``set_noise``
    replaced by one drawn uniformly from all ``n_clusters`` pools."""
    n, vocab = cluster.size, cfg.set_vocab_per_cluster
    counts = np.maximum(rng.binomial(cap, cfg.set_fill, size=n), 1)
    items = (cluster[:, None] * vocab
             + rng.integers(0, vocab, (n, cap), dtype=np.int32))
    noise = rng.random((n, cap), dtype=np.float32) < cfg.set_noise
    items[noise] = rng.integers(0, cfg.n_clusters * vocab, int(noise.sum()),
                                dtype=np.int32)
    items[np.arange(cap)[None, :] >= counts[:, None]] = PAD_ITEM
    return items


def labeled_pair_rows(cluster: np.ndarray, n_pairs: int, seed: int):
    """The row pairs and labels of ``repro_torch.data.synthetic.
    labeled_pairs`` (balanced positives within clusters, random
    negatives), in its order: (a int64 [P], b int64 [P], labels f32 [P]).
    The caller computes the pair features."""
    rng = np.random.default_rng(seed)
    n = cluster.shape[0]
    half = n_pairs // 2
    order = np.argsort(cluster)
    sorted_cl = cluster[order]
    starts = np.searchsorted(sorted_cl, np.arange(cluster.max() + 1))
    ends = np.append(starts[1:], n)
    sizes = ends - starts
    eligible = np.nonzero(sizes >= 2)[0]
    choice = rng.choice(eligible, half)
    pos_a, pos_b = [], []
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
    labels = np.concatenate([np.ones(half), (cluster[a[half:]]
                                             == cluster[b[half:]]).astype(float)])
    perm = rng.permutation(a.size)
    return a[perm], b[perm], labels[perm].astype(np.float32)


@dataclasses.dataclass
class Batch:
    """One mutation RPC: kinds int32 [B], ids int64 [B], features."""
    kinds: np.ndarray
    ids: np.ndarray
    features: dict


class MutationStream:
    """Batches of inserts, updates and deletes over a held-out part of a
    corpus: the draws of ``repro_torch.data.stream.MutationStream``."""

    def __init__(self, ids: np.ndarray, features: dict, *, seed: int,
                 bootstrap_fraction: float, batch_size: int = 64,
                 insert_frac: float = 0.6, update_frac: float = 0.25,
                 jitter: float = 0.05):
        self.features = features
        self.batch_size = batch_size
        self.insert_frac = insert_frac
        self.update_frac = update_frac
        self.jitter = jitter
        n_boot = int(len(ids) * bootstrap_fraction)
        self.boot_ids = ids[:n_boot]
        self.pending = list(ids[n_boot:].tolist())
        self.live = set(self.boot_ids.tolist())
        self.rng = np.random.default_rng(seed)
        self.next_fresh_id = int(ids.max()) + 1

    def bootstrap(self):
        return self.boot_ids, {k: v[self.boot_ids]
                               for k, v in self.features.items()}

    def _features_of(self, ids: np.ndarray) -> dict:
        base = {k: np.array(v[ids % v.shape[0]])
                for k, v in self.features.items()}
        if self.jitter > 0:
            for k in base:
                if k.startswith("dense:"):
                    base[k] = base[k] + self.jitter * self.rng.normal(
                        size=base[k].shape).astype(np.float32)
        return base

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        kinds, ids = [], []
        live_list = list(self.live)
        for _ in range(self.batch_size):
            u = self.rng.random()
            if u < self.insert_frac or len(live_list) < 4:
                if self.pending:
                    pid = self.pending.pop()
                else:
                    pid = self.next_fresh_id
                    self.next_fresh_id += 1
                kinds.append(MUTATION_INSERT)
                self.live.add(pid)
                live_list.append(pid)
            elif u < self.insert_frac + self.update_frac:
                pid = live_list[int(self.rng.integers(len(live_list)))]
                kinds.append(MUTATION_UPDATE)
            else:
                pid = live_list.pop(int(self.rng.integers(len(live_list))))
                self.live.discard(pid)
                kinds.append(MUTATION_DELETE)
            ids.append(pid)
        ids_np = np.asarray(ids, np.int64)
        return Batch(kinds=np.asarray(kinds, np.int32), ids=ids_np,
                     features=self._features_of(ids_np))
