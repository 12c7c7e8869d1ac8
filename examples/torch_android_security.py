"""Android-Security walkthrough on the PyTorch port (the counterpart of
``examples/android_security.py``): the paper's headline multi-modal win.

A malicious app's *dense* embedding takes time to converge after release,
but its *sparse* signals (shared signature tokens) are there from the
first sighting, so a scorer over heterogeneous pair features links a new
app to its malware family long before a single-embedding ANN would
("capturing harmful applications 4x faster", §1). The tour:

1. generate the streaming scenario (``AndroidSecurityStream``): benign
   apps, pre-labeled bad seeds, and malware-family arrivals whose dense
   views converge only ``converge_after`` batches after insert;
2. train the pairwise scorer on the stream's ``training_pairs``;
3. serve the SAME stream through a dense-only engine and a
   ``GusConfig(multimodal=...)`` engine sharing that scorer (the recipes
   of ``benchmarks/torch_time_to_flag.py::build_gus``);
4. flag via label propagation over the maintained graph
   (``graph.cc.propagate_flags``) and print the mutations-until-flag
   comparison.

    PYTHONPATH=src python examples/torch_android_security.py [--device cpu]

``--device`` defaults to the CUDA card.
"""
import argparse
import os
import sys

import numpy as np

# the engine recipes live in benchmarks/ (repo root, not src/)
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from repro_torch.core.scorer import train_scorer  # noqa: E402
from repro_torch.data.synthetic import (AndroidSecurityConfig,  # noqa: E402
                                        AndroidSecurityStream)
from repro_torch.graph.cc import propagate_flags  # noqa: E402

FLAG_WEIGHT = 0.5


def main(argv=None):
    ap = argparse.ArgumentParser(description="Android-Security time-to-flag")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = AndroidSecurityConfig(n_benign=200, n_families=3,
                                apps_per_family=4, converge_after=5)
    stream = AndroidSecurityStream(cfg)
    boot_ids, boot_feats = stream.bootstrap()
    batches = list(stream.batches())
    print(f"stream: {len(boot_ids)} bootstrap points "
          f"({len(stream.seed_bad_ids)} known-bad seeds), "
          f"{len(batches)} mutation batches, "
          f"{len(stream.harmful_ids)} harmful arrivals")

    feats, labels = stream.training_pairs()
    params, losses = train_scorer(7, stream.spec, feats, labels, steps=300,
                                  device=args.device)
    print(f"scorer: trained on {labels.shape[0]} labeled pairs, "
          f"final loss {losses[-1]:.4f}")

    # build_gus holds the two engine recipes (the only difference: the
    # multimodal= knob and set-token bucket tables)
    from benchmarks.torch_time_to_flag import build_gus

    results = {}
    for mode in ("dense-only", "multimodal"):
        gus = build_gus(stream.spec, params,
                        multimodal=mode == "multimodal", device=args.device)
        gus.bootstrap(boot_ids, boot_feats)
        flagged_at = {}
        for b, batch in enumerate(batches):
            gus.mutate(batch)
            pairs, weights = gus.graph.edges()
            flags = propagate_flags(pairs, weights, gus.store.ids(),
                                    stream.seed_bad_ids, FLAG_WEIGHT)
            for pid in stream.harmful_ids:
                if pid not in flagged_at and flags.get(pid, False):
                    flagged_at[pid] = b
        waits = [(flagged_at.get(pid, len(batches) - 1)
                  - stream.arrival_batch[pid] + 1) * cfg.batch_size
                 for pid in stream.harmful_ids]
        results[mode] = float(np.mean(waits))
        print(f"{mode:>11}: {len(flagged_at)}/{len(stream.harmful_ids)} "
              f"apps flagged, mean {results[mode]:.1f} mutations "
              "between arrival and flag")

    ratio = results["dense-only"] / max(results["multimodal"], 1e-9)
    print(f"\nmultimodal flags harmful apps {ratio:.1f}x faster — the "
          "sparse signature tokens route each arrival to its family's "
          "seeds at insert time, and the learned re-score turns that "
          "into a flagging-strength edge before the dense view converges")
    print(f"[android_security] ratio={ratio:.4f}")


if __name__ == "__main__":
    main()
