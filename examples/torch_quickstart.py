"""Quickstart on the PyTorch port (the counterpart of
``examples/quickstart.py``): build a Dynamic GUS instance, insert points,
query neighbors.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

``--device`` defaults to the CUDA card. The scorer, the bucket
hyperplanes and k-means are torch-seeded, so the numbers are not the JAX
example's; the last line gives the same-cluster rate over every returned
neighbor.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.ann import ScannConfig
from repro_torch.core import (BucketConfig, DynamicGUS, GusConfig,
                              MutationBatch, MUTATION_INSERT)
from repro_torch.core.scorer import train_scorer
from repro_torch.data.synthetic import (OGB_ARXIV_LIKE, labeled_pairs,
                                        make_dataset)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Dynamic GUS quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # 1) a synthetic multimodal corpus (ogbn-arxiv-like: text embedding +
    #    publication year) with planted clusters
    data_cfg = dataclasses.replace(OGB_ARXIV_LIKE, n_points=3000,
                                   n_clusters=25)
    ids, feats, cluster = make_dataset(data_cfg)

    # 2) offline preprocessing (paper §4.3): train the similarity scorer
    pf, lbl = labeled_pairs(feats, cluster, 4000, data_cfg.spec, seed=0)
    scorer, losses = train_scorer(0, data_cfg.spec, pf, lbl, steps=300,
                                  device=args.device)
    print(f"scorer trained: loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    # 3) the Dynamic GUS service: LSH buckets -> sparse embeddings ->
    #    quantized dynamic index -> model-scored neighborhoods
    gus = DynamicGUS(
        data_cfg.spec,
        BucketConfig(dense_tables=8, dense_bits=10, scalar_widths=(2.0,)),
        scorer,
        GusConfig(scann_nn=10, idf_size=10_000, filter_percent=10,
                  scann=ScannConfig(d_proj=64, n_partitions=32, nprobe=8)),
        device=args.device)
    gus.bootstrap(ids[:2500], {k: v[:2500] for k, v in feats.items()})
    print(f"bootstrapped {len(gus.index)} points")

    # 4) mutation RPC: insert 100 new points (visible immediately)
    gus.mutate(MutationBatch(
        kinds=np.full(100, MUTATION_INSERT, np.int32),
        ids=ids[2500:2600],
        features={k: v[2500:2600] for k, v in feats.items()}))
    print(f"after inserts: {len(gus.index)} points")

    # 5) neighborhood RPC for brand-new points (never inserted)
    res = gus.neighbors({k: v[2900:2905] for k, v in feats.items()}, k=5)
    every = []
    for r in range(5):
        same = [cluster[n] == cluster[2900 + r] for n in res.ids[r] if n >= 0]
        every += same
        print(f"query {2900 + r}: neighbors {res.ids[r].tolist()} "
              f"weights {np.round(res.weights[r], 3).tolist()} "
              f"(same-cluster {np.mean(same):.0%})")
    print("latency:", gus.query_timer.summary())
    print(f"[quickstart] same-cluster={np.mean(every):.4f} "
          f"over {len(every)} neighbors")


if __name__ == "__main__":
    main()
