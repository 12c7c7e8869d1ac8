"""Android-Security time-to-flag on the PyTorch port: the paper's headline
multi-modal claim ("capturing harmful applications 4x faster", §1), at
the settings of the smoke lane of ``benchmarks/time_to_flag.py``.

One seeded mutation stream (``repro_torch.data.synthetic.
AndroidSecurityStream``): malware-family apps arrive with unconverged
dense embeddings but their family's sparse signature tokens, and get the
converged dense view ``converge_after`` batches later. The same stream
replays into two engines sharing one scorer, trained 300 steps from
torch seed 7 on the stream's labelled pairs:

* dense-only: dense SimHash buckets only (the single-embedding-ANN
  baseline);
* multi-modal: ``GusConfig(multimodal=...)``, whose sparse/bucket
  candidate stage routes the shared signature tokens to the pre-labelled
  seeds at insert time.

Both use the exact brute index and a maintained graph with k = 5. A
harmful app counts as flagged once it shares a component of edges of
weight >= 0.5 with a known-bad seed (``graph.cc.propagate_flags``). The
ratio of the two sides' mean mutations until flagged,
``multimodal_time_to_flag_ratio``, must be >= 2.0; the rescore p50 comes
from the port's ``multimodal_rescore_ms`` histogram.

    PYTHONPATH=src python benchmarks/torch_time_to_flag.py --device cuda

It imports the port only (no JAX), so ``chip_smoke.py`` runs it on the
card. The ratio counts mutations, not seconds, so it compares with the
reference's as it is.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.core.buckets import BucketConfig
from repro_torch.core.gus import DynamicGUS, GusConfig
from repro_torch.core.scorer import train_scorer
from repro_torch.data.synthetic import (AndroidSecurityConfig,
                                        AndroidSecurityStream)
from repro_torch.graph.cc import propagate_flags
from repro_torch.graph.store import GraphConfig
from repro_torch.multimodal import MultiModalConfig

FLAG_WEIGHT = 0.5   # min scored edge weight that propagates the label
RATIO_GATE = 2.0


def build_gus(spec, params, multimodal: bool, device=None) -> DynamicGUS:
    if multimodal:
        bucket_cfg = BucketConfig(dense_tables=8, dense_bits=10,
                                  set_tables=6)
        cfg = GusConfig(scann_nn=10, backend="brute",
                        graph=GraphConfig(k=5),
                        multimodal=MultiModalConfig(
                            sparse_k=10, d_sketch=32, idf_size=256,
                            filter_percent=1.0))
    else:
        # the single-embedding-ANN baseline: dense SimHash buckets only
        bucket_cfg = BucketConfig(dense_tables=8, dense_bits=10,
                                  set_tables=0)
        cfg = GusConfig(scann_nn=10, backend="brute",
                        graph=GraphConfig(k=5))
    return DynamicGUS(spec, bucket_cfg, params, cfg, device=device)


def mutations_to_flag(gus: DynamicGUS, boot, batches, stream,
                      batch_size: int) -> dict:
    """Replay the stream; per harmful app, mutation rows applied between
    its arrival batch and the first batch after which it shares a flagged
    component with a seed (unflagged apps score the stream remainder)."""
    boot_ids, boot_feats = boot
    gus.bootstrap(boot_ids, boot_feats)
    flagged_at: dict[int, int] = {}
    for b, batch in enumerate(batches):
        gus.mutate(batch)
        pairs, weights = gus.graph.edges()
        flags = propagate_flags(pairs, weights, gus.store.ids(),
                                stream.seed_bad_ids, FLAG_WEIGHT)
        for pid in stream.harmful_ids:
            if pid not in flagged_at and flags.get(pid, False):
                flagged_at[pid] = b
    last = len(batches) - 1
    per_app = {}
    for pid in stream.harmful_ids:
        until = flagged_at.get(pid, last)
        per_app[pid] = (until - stream.arrival_batch[pid] + 1) * batch_size
    return {"per_app": per_app,
            "mean_mutations": float(np.mean(list(per_app.values()))),
            "flagged": len(flagged_at), "total": len(stream.harmful_ids)}


def run(cfg: AndroidSecurityConfig = AndroidSecurityConfig(),
        scorer_steps: int = 300, device=None) -> dict:
    stream = AndroidSecurityStream(cfg)
    boot = stream.bootstrap()
    batches = list(stream.batches())   # one stream, replayed twice
    feats, labels = stream.training_pairs()
    params, losses = train_scorer(7, stream.spec, feats, labels,
                                  steps=scorer_steps, device=device)
    out = {}
    for mode in ("dense", "multimodal"):
        gus = build_gus(stream.spec, params, mode == "multimodal", device)
        out[mode] = mutations_to_flag(gus, boot, batches, stream,
                                      cfg.batch_size)
        if mode == "multimodal":
            summary = gus.multimodal.obs.registry.get(
                "multimodal_rescore_ms").summary()
            out["rescore_p50_ms"] = summary.get("p50_ms", 0.0)
            out["multimodal_store"] = gus.multimodal.describe()
    out["ratio"] = out["dense"]["mean_mutations"] / max(
        out["multimodal"]["mean_mutations"], 1e-9)
    out["scorer_final_loss"] = losses[-1]
    out["device"] = str(gus.device)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args()
    out = run(device=args.device)
    if args.device == "cuda":
        import torch
        out["device"] = torch.cuda.get_device_name(0)
    for mode in ("dense", "multimodal"):
        r = out[mode]
        print(f"{mode}: mean mutations-to-flag {r['mean_mutations']} "
              f"({r['flagged']}/{r['total']} flagged)")
    print(json.dumps({k: out[k] for k in (
        "ratio", "rescore_p50_ms", "scorer_final_loss", "device")}))
    if not out["ratio"] >= RATIO_GATE:
        print(f"multimodal time-to-flag ratio {out['ratio']} < {RATIO_GATE}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
