"""GUS serving launcher (port of ``repro/launch/serve.py``): bootstrap a
corpus, run a live mutation + query workload through the engine, and
report paper-style latency percentiles.

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset arxiv \\
        --points 5000 --mutations 50 --queries 200

Runs on the card unless ``--device cpu`` is given. ``--metrics
{json,prom,full}`` dumps the telemetry plane at the end (registry
snapshot / Prometheus text / full ``GusEngine.telemetry()`` with
lifecycle events and trace stats); ``--trace-every N`` sets the
request-trace sampling rate. Catalog: docs/OBSERVABILITY.md. The scorer
is the port's ``train_scorer`` from seed 0. ``--backend sharded --shards
N`` serves from N index shards, placed as ``launch/mesh.py`` places them
(on one card, every shard shares it; with ``--device cpu``, the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.ann.scann import ScannConfig
from repro_torch.ann.sharded_index import ShardedConfig
from repro_torch.core.buckets import BucketConfig
from repro_torch.core.gus import DynamicGUS, GusConfig
from repro_torch.core.scorer import train_scorer
from repro_torch.data.stream import MutationStream, StreamConfig
from repro_torch.data.synthetic import (OGB_ARXIV_LIKE, OGB_PRODUCTS_LIKE,
                                        labeled_pairs, make_dataset)
from repro_torch.serve.engine import EngineConfig, GusEngine

DATASETS = {"arxiv": OGB_ARXIV_LIKE, "products": OGB_PRODUCTS_LIKE}
BUCKETS = BucketConfig(dense_tables=8, dense_bits=10, set_tables=6,
                       scalar_widths=(2.0,))


def gus_config(n_points: int, *, scann_nn=10, idf_size=0, filter_percent=0.0,
               backend="scann", shards=1) -> GusConfig:
    """Serving config sized to the corpus, for any backend."""
    n_parts = max(16, n_points // 256)
    return GusConfig(
        scann_nn=scann_nn, idf_size=idf_size, filter_percent=filter_percent,
        backend=backend,
        scann=ScannConfig(d_proj=64, n_partitions=n_parts,
                          nprobe=8, reorder=max(128, scann_nn * 4)),
        sharded=ShardedConfig(
            n_shards=shards,
            n_partitions=max(16, (n_parts + shards - 1) // shards * shards),
            nprobe_local=0, reorder=max(128, scann_nn * 4),
            kmeans_iters=8, pq_iters=4))


def build_engine(dataset: str, n_points: int, *, scann_nn=10, idf_size=0,
                 filter_percent=0.0, backend="scann", shards=1, replicas=0,
                 seed=0, engine_cfg: EngineConfig = EngineConfig(),
                 device=None):
    """Bootstrap a full serving engine; ``replicas`` extra DynamicGUS
    instances (same corpus, same seed) back the straggler-hedging path.
    Returns (engine, stream, cluster labels)."""
    data_cfg = dataclasses.replace(DATASETS[dataset], n_points=n_points)
    ids, feats, cluster = make_dataset(data_cfg)
    pf, lbl = labeled_pairs(feats, cluster, min(4 * n_points, 20000),
                            data_cfg.spec, seed=seed)
    scorer, _ = train_scorer(seed, data_cfg.spec, pf, lbl, steps=300,
                             device=device)
    cfg = gus_config(n_points, scann_nn=scann_nn, idf_size=idf_size,
                     filter_percent=filter_percent, backend=backend,
                     shards=shards)
    stream = MutationStream(data_cfg, StreamConfig(seed=seed),
                            bootstrap_fraction=0.6)
    boot_ids, boot_feats = stream.bootstrap()
    fleet = []
    for _ in range(1 + replicas):
        gus = DynamicGUS(data_cfg.spec, BUCKETS, scorer, cfg, device=device)
        gus.bootstrap(boot_ids, boot_feats)
        fleet.append(gus)
    return GusEngine(fleet[0], engine_cfg, fleet[1:]), stream, cluster


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=DATASETS, default="arxiv")
    ap.add_argument("--points", type=int, default=5000)
    ap.add_argument("--mutations", type=int, default=50)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--scann-nn", type=int, default=10)
    ap.add_argument("--idf-size", type=int, default=0)
    ap.add_argument("--filter-percent", type=float, default=0.0)
    ap.add_argument("--backend", choices=("scann", "brute", "sharded"),
                    default="scann")
    ap.add_argument("--shards", type=int, default=1,
                    help="index shards for --backend sharded")
    ap.add_argument("--replicas", type=int, default=0,
                    help="replica fleet size backing straggler hedging")
    ap.add_argument("--pipeline", action="store_true",
                    help="async double-buffered write path "
                         "(serve.pipeline.MutationPipeline)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--metrics", choices=("json", "prom", "full"),
                    default=None,
                    help="dump the telemetry plane after the run: 'json' "
                         "(registry snapshot), 'prom' (Prometheus text "
                         "exposition), 'full' (GusEngine.telemetry(): "
                         "metrics + lifecycle events + trace stats)")
    ap.add_argument("--trace-every", type=int, default=None,
                    help="trace sampling rate (0 = off, 1 = every "
                         "request, N = every Nth; default: obs package "
                         "default)")
    args = ap.parse_args(argv)

    engine, stream, cluster = build_engine(
        args.dataset, args.points, scann_nn=args.scann_nn,
        idf_size=args.idf_size, filter_percent=args.filter_percent,
        backend=args.backend, shards=args.shards, replicas=args.replicas,
        engine_cfg=EngineConfig(pipeline=args.pipeline), device=args.device)
    if args.trace_every is not None:
        engine.obs.tracer.sample_every = args.trace_every
    print(f"[serve] bootstrapped {len(engine.gus.index)} points")

    for i, batch in zip(range(args.mutations), stream):
        engine.submit_mutations(batch)
        if args.queries and i % max(args.mutations // 10, 1) == 0:
            engine.flush()       # the probe below bypasses engine.query
            qids = stream.query_ids(min(16, args.queries))
            res = engine.gus.neighbors_of_ids(qids)
            same = [cluster[n] == cluster[q]
                    for r, q in enumerate(qids)
                    for n in res.ids[r] if 0 <= n < len(cluster)]
            print(f"[serve] after batch {i}: index={len(engine.gus.index)} "
                  f"same-cluster={np.mean(same):.2f}")
    engine.flush()
    print(json.dumps(engine.describe(), indent=1, default=str))
    if args.metrics == "prom":
        print(engine.obs.registry.to_prometheus())
    elif args.metrics == "json":
        print(engine.obs.registry.to_json(indent=1))
    elif args.metrics == "full":
        print(json.dumps(engine.telemetry(), indent=1, default=str))


if __name__ == "__main__":
    main()
