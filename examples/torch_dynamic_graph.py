"""Maintained dynamic graph demo on the PyTorch port (the counterpart of
``examples/dynamic_graph.py``): the paper's Android-Security-style
workload in miniature — a live mutation stream drives the GUS engine,
which keeps a symmetrized top-k graph and its connected components up to
date incrementally; neighborhood queries for existing points are served
straight from the maintained rows (no re-embed / re-search), and a crash
is recovered with the graph state restored from the snapshot.

    PYTHONPATH=src python examples/torch_dynamic_graph.py [--device cpu]

``--device`` defaults to the CUDA card.
"""
import argparse
import dataclasses
import json
import time

import numpy as np

from repro_torch.ann import ScannConfig
from repro_torch.core import (BucketConfig, DynamicGUS, GraphConfig,
                              GusConfig)
from repro_torch.core.scorer import train_scorer
from repro_torch.data import MutationStream, StreamConfig
from repro_torch.data.synthetic import (OGB_ARXIV_LIKE, labeled_pairs,
                                        make_dataset)
from repro_torch.serve.engine import EngineConfig, GusEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description="maintained dynamic graph")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    data_cfg = dataclasses.replace(OGB_ARXIV_LIKE, n_points=1200,
                                   n_clusters=12)
    ids, feats, cluster = make_dataset(data_cfg)
    pf, lbl = labeled_pairs(feats, cluster, 3000, data_cfg.spec, seed=0)
    scorer, _ = train_scorer(0, data_cfg.spec, pf, lbl, steps=200,
                             device=args.device)
    cfg = GusConfig(
        scann_nn=8,
        scann=ScannConfig(d_proj=64, n_partitions=32, nprobe=8),
        graph=GraphConfig(k=8, capacity=2048))
    bucket_cfg = BucketConfig(dense_tables=8, dense_bits=10)
    gus = DynamicGUS(data_cfg.spec, bucket_cfg, scorer, cfg,
                     device=args.device)
    stream = MutationStream(data_cfg, StreamConfig(batch_size=64, seed=1),
                            bootstrap_fraction=0.5)
    bids, bfeats = stream.bootstrap()
    gus.bootstrap(bids, bfeats)
    engine = GusEngine(gus, EngineConfig(snapshot_every=5))
    g = gus.graph.describe()
    print(f"bootstrapped: {g['nodes']} nodes, {g['edges']} edges, "
          f"{len(set(gus.graph.components().values()))} components")

    for i, batch in zip(range(15), stream):
        engine.submit_mutations(batch)
        if i % 5 == 4:
            comps = gus.graph.components()
            g = gus.graph.describe()
            print(f"batch {i:3d}: nodes={g['nodes']:5d} edges={g['edges']:6d} "
                  f"components={len(set(comps.values())):3d} "
                  f"cc_rounds={g['cc_iters']}")

    # the fast path: neighborhoods of existing points come from the graph
    qids = stream.query_ids(16)
    t0 = time.perf_counter()
    fast = gus.neighbors_of_ids(qids, k=8)
    t_fast = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = gus._index_neighbors_of_ids(qids, k=8)
    t_slow = time.perf_counter() - t0
    overlap = np.mean([
        len(set(fast.ids[r][fast.ids[r] >= 0]) &
            set(slow.ids[r][slow.ids[r] >= 0]))
        / max((fast.ids[r] >= 0).sum(), 1) for r in range(len(qids))])
    print(f"fast path {t_fast * 1e3:.1f}ms vs index path {t_slow * 1e3:.1f}ms"
          f" ({t_slow / max(t_fast, 1e-9):.1f}x), neighbor overlap "
          f"{overlap:.2f}")

    # crash + recover: the graph comes back from the snapshot, not a rebuild
    fresh = DynamicGUS(data_cfg.spec, bucket_cfg, scorer, cfg,
                       device=args.device)
    engine.recover(fresh)
    p_old, _ = gus.graph.edges()
    p_new, _ = fresh.graph.edges()
    same = {tuple(p) for p in p_old.tolist()} == \
        {tuple(p) for p in p_new.tolist()}
    print(f"recovered: {len(fresh.graph)} nodes, edge set identical: {same}")
    print(json.dumps(engine.describe().get("graph", {}), indent=1,
                     default=str))
    print(f"[dynamic_graph] recovered={len(fresh.graph)} "
          f"live={len(gus.graph)} edges_identical={same} "
          f"overlap={overlap:.4f}")


if __name__ == "__main__":
    main()
