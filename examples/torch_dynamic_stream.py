"""Dynamic environment demo on the PyTorch port (the counterpart of
``examples/dynamic_stream.py``): a live mutation stream (insert / update /
delete) with concurrent neighborhood queries and freshness accounting —
the paper's §5.2 workload in miniature — then a crash and a recovery from
the snapshot and the log.

    PYTHONPATH=src python examples/torch_dynamic_stream.py [--device cpu]

``--device`` defaults to the CUDA card.
"""
import argparse
import dataclasses
import json

import numpy as np

from repro_torch.ann import ScannConfig
from repro_torch.core import BucketConfig, DynamicGUS, GusConfig
from repro_torch.core.scorer import train_scorer
from repro_torch.data import MutationStream, StreamConfig
from repro_torch.data.synthetic import (OGB_PRODUCTS_LIKE, labeled_pairs,
                                        make_dataset)
from repro_torch.serve.engine import EngineConfig, GusEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description="Dynamic GUS mutation stream")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    data_cfg = dataclasses.replace(OGB_PRODUCTS_LIKE, n_points=4000,
                                   n_clusters=30)
    ids, feats, cluster = make_dataset(data_cfg)
    pf, lbl = labeled_pairs(feats, cluster, 4000, data_cfg.spec, seed=0)
    scorer, _ = train_scorer(0, data_cfg.spec, pf, lbl, steps=250,
                             device=args.device)
    buckets = BucketConfig(dense_tables=8, dense_bits=10, set_tables=6)
    gus = DynamicGUS(
        data_cfg.spec, buckets, scorer,
        GusConfig(scann_nn=10,
                  scann=ScannConfig(d_proj=64, n_partitions=32, nprobe=8)),
        device=args.device)
    stream = MutationStream(data_cfg, StreamConfig(batch_size=64, seed=1),
                            bootstrap_fraction=0.5)
    bids, bfeats = stream.bootstrap()
    gus.bootstrap(bids, bfeats)
    engine = GusEngine(gus, EngineConfig(snapshot_every=10))
    print(f"bootstrapped {len(gus.index)}")

    every = []
    for i, batch in zip(range(30), stream):
        engine.submit_mutations(batch)
        if i % 5 == 0:
            qids = stream.query_ids(8)
            res = engine.gus.neighbors_of_ids(qids, k=5)
            same = [cluster[n % len(cluster)] == cluster[q % len(cluster)]
                    for r, q in enumerate(qids) for n in res.ids[r] if n >= 0]
            every += same
            print(f"batch {i:3d}: live={len(engine.gus.index):5d} "
                  f"same-cluster={np.mean(same):.2f}")

    # simulate a crash + recovery from snapshot + log replay
    fresh = DynamicGUS(data_cfg.spec, buckets, scorer, gus.cfg,
                       device=args.device)
    engine.recover(fresh)
    print(f"recovered engine: live={len(fresh.index)} "
          f"(was {len(engine.gus.index)})")
    print(json.dumps(engine.describe(), indent=1, default=str))
    print(f"[dynamic_stream] same-cluster={np.mean(every):.4f} "
          f"recovered={len(fresh.index)} live={len(engine.gus.index)}")


if __name__ == "__main__":
    main()
