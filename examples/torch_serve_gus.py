"""End-to-end serving driver on the PyTorch port (the counterpart of
``examples/serve_gus.py``): a small model served with batched requests.

Drives the full production path: offline bootstrap -> engine with request
batching + replica hedging -> a mixed workload of mutation batches and
batched neighborhood queries -> latency/freshness report (the paper's
Fig. 9/10 shape). ``--sweep-shards`` replays the same workload against the
sharded backend at 1/2/4 index shards; shard i goes on
``cuda:{i % device_count}`` (every shard on the one card of a one-card
host, or all on the CPU with ``--device cpu``), so no device count has to
be forced.

    PYTHONPATH=src python examples/torch_serve_gus.py --requests 40
    PYTHONPATH=src python examples/torch_serve_gus.py --sweep-shards

``--device`` defaults to the CUDA card.
"""
import argparse
import json

import numpy as np

from repro_torch.launch.serve import build_engine


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Dynamic GUS serving driver")
    ap.add_argument("--points", type=int, default=4000)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--backend", choices=("scann", "brute", "sharded"),
                    default="scann")
    ap.add_argument("--shards", type=int, default=1,
                    help="index shards for --backend sharded")
    ap.add_argument("--replicas", type=int, default=0,
                    help="replica fleet backing straggler hedging")
    ap.add_argument("--sweep-shards", action="store_true",
                    help="run the workload at shards=1,2,4 (sharded "
                         "backend) and report per-shard latency")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def drive(engine, stream, cluster, requests: int, batch: int):
    rng = np.random.default_rng(0)
    quality = []
    for _ in range(requests):
        if rng.random() < 0.4:                      # mutation RPC batch
            engine.submit_mutations(next(stream))
        else:                                       # batched query RPC
            qids = stream.query_ids(batch)
            feats = engine.gus.store.gather(qids)
            res = engine.query(feats, k=10)
            same = [cluster[n % len(cluster)] == cluster[q % len(cluster)]
                    for r, q in enumerate(qids)
                    for n in res.ids[r] if n >= 0]
            quality.append(np.mean(same))
    stats = engine.describe()
    stats["mean_same_cluster"] = float(np.mean(quality))
    return stats


def main(argv=None):
    args = parse_args(argv)
    sweep = (1, 2, 4) if args.sweep_shards else (args.shards,)
    backend = "sharded" if args.sweep_shards else args.backend
    for shards in sweep:
        engine, stream, cluster = build_engine(
            "arxiv", args.points, scann_nn=10, idf_size=10_000,
            filter_percent=10, backend=backend, shards=shards,
            replicas=args.replicas, device=args.device)
        tag = f"backend={backend} shards={shards}"
        print(f"[serve_gus] bootstrapped {len(engine.gus.index)} points "
              f"({tag})")
        stats = drive(engine, stream, cluster, args.requests, args.batch)
        print(json.dumps(stats, indent=1, default=str))
        q = stats["query_latency"]
        print(f"[serve_gus] {tag} query p50={q['p50_ms']:.1f}ms "
              f"p99={q['p99_ms']:.1f}ms"
              f" | quality={stats['mean_same_cluster']:.2f}"
              f" | hedged={stats['hedged']}")


if __name__ == "__main__":
    main()
