"""A configuration, a traffic mix and a per-layer metric are files found
by name: a new cell runs from new files and entries alone."""
import dataclasses
import json
import shutil

import pytest
import torch

from harness import data
from harness.runner import lsh_planes, run_cell
from references import dense_gus


def test_new_cell_from_new_files(root, tiny, tmp_path):
    bench = tmp_path / "gusbench"
    shutil.copytree(root / "gusbench", bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "arxiv-index.json").read_text())
    cfg["name"] = "arxiv-wide"
    cfg["index"]["nprobe"] = 12
    (bench / "configs" / "arxiv-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "reads.json").read_text())
    mix["cycle"][0]["ids"] = 4
    (bench / "traffic" / "small-reads.json").write_text(json.dumps(mix))
    (bench / "metrics" / "queries.count.py").write_text(
        "def read(t):\n"
        "    return float(sum(r['kind'] == 'query' for r in t.requests))\n")
    spec["configs"].append({"name": "arxiv-wide", "source": "x",
                            "file": "gusbench/configs/arxiv-wide.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "arxiv-wide.small-reads",
                              "config": "arxiv-wide",
                              "traffic": "small-reads", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "queries.count", "unit": "requests",
                              "better": "higher", "source": "program_counter",
                              "layer": "engine", "moves": "query_rpcs_per_s",
                              "workloads": ["arxiv-wide.small-reads"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "arxiv-index.reads" in m["workloads"]:
            m["workloads"].append("arxiv-wide.small-reads")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "gusbench" / "configs").mkdir(exist_ok=True)
    out = run_cell(tmp_path, "arxiv-wide.small-reads", 3, 1.0, True,
                   device="cpu", overrides=tiny, bench=bench)
    assert out["correct"], out["checks"]
    assert out["metrics"]["queries.count"]["value"] > 0
    assert "engine_self_ms.query" not in out["metrics"]
    plain = run_cell(tmp_path, "arxiv-wide.small-reads", 3, 1.0, False,
                     device="cpu", overrides=tiny, bench=bench)
    assert {"setup_s", "query_rpcs_per_s"} == set(plain["metrics"])


def _minhash_reseeded(system):
    """The program's MinHash keyed by another seed than the run's (its
    SimHash planes unchanged), for every RPC after the bootstrap."""
    emb = system.gus.embedder
    system.gus.embedder = dataclasses.replace(
        emb, cfg=dataclasses.replace(emb.cfg, seed=emb.cfg.seed + 1))


# the reference with its set tables dropped: the embedding of the dense
# modes alone, padded to the program's width
NOSET = '''import dataclasses
import numpy as np
from references.grale_gus import *  # noqa: F401,F403
from references import grale_gus


def embed(features, spec, buckets, planes, device, precision="exact"):
    rows = grale_gus.embed(features, dataclasses.replace(spec, sets=()),
                           buckets, planes, device, precision)
    pad = np.full((rows.shape[0], len(spec.sets) * buckets["set_tables"]),
                  grale_gus.PAD_INDEX, rows.dtype)
    return np.concatenate([rows, pad], 1)
'''


@pytest.fixture
def products_root(root, tmp_path):
    """A checkout root with a products-shaped cell (ogbn-products' schema:
    a 100-wide dense mode and a 16-item set mode; 2,000 points, 16
    partitions) added from new files and entries alone."""
    bench = tmp_path / "gusbench"
    shutil.copytree(root / "gusbench", bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = json.loads((bench / "configs" / "arxiv-index.json").read_text())
    cfg["name"] = "products-tiny"
    cfg["reference"] = "grale_gus"
    cfg["corpus"].update(n_points=2000, n_clusters=47, dense_noise=0.4,
                         set_vocab_per_cluster=40,
                         spec={"dense": {"bow_pca": 100},
                               "sets": {"copurchase": 16}})
    cfg["index"]["n_partitions"] = 16
    # sound runs of this size read recall_miss 0.19-0.25 (8 seeds; 0.23-0.26
    # with all 16 partitions probed, 0.01 with every point rescored: the
    # PQ shortlist's loss on this schema), above arxiv's 0.04-0.06
    cfg["limits"]["recall_miss"] = 0.35
    (bench / "configs" / "products-tiny.json").write_text(json.dumps(cfg))
    (bench / "references" / "grale_noset.py").write_text(NOSET)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "products-tiny", "source": "x",
                            "file": "gusbench/configs/products-tiny.json",
                            "reduced": ["n_points"], "why": "x"})
    spec["workloads"].append({"name": "products-tiny.reads",
                              "config": "products-tiny", "traffic": "reads",
                              "chips": 1, "why": "x"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "arxiv-index.reads" in m.get("workloads", ()):
            m["workloads"].append("products-tiny.reads")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path, bench


def _products_run(products_root, **kw):
    root, bench = products_root
    return run_cell(root, "products-tiny.reads", 5, 1.0, False,
                    device="cpu", bench=bench, **kw)


def test_products_cell_from_new_files(products_root):
    out = _products_run(products_root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    assert {"setup_s", "query_rpcs_per_s"} == set(out["metrics"])


@pytest.mark.parametrize("fault", ["minhash_seed", "no_set_tables",
                                   "control"])
def test_products_cell_faults(products_root, fault):
    kw = {"minhash_seed": {"hook": _minhash_reseeded},
          "no_set_tables": {"overrides": {
              "config": {"reference": "grale_noset"}}},
          "control": {"control": True}}[fault]
    out = _products_run(products_root, **kw)
    failing = {n for n, c in out["checks"].items()
               if not c["value"] <= c["limit"]}
    assert not out["correct"]
    assert "dist_mismatch" in failing, out["checks"]


def test_runner_planes_for_one_dense_mode():
    """The runner's planes, drawn for every dense mode from one generator,
    are the dense reference's for a single mode."""
    spec = data.Spec(dense=(("text", 128),), scalars=("year",))
    for seed in (0, 5, 2 ** 31 - 1):
        planes = lsh_planes(spec, {"seed": seed, "dense_tables": 8,
                                   "dense_bits": 10})
        assert list(planes) == ["text"]
        assert torch.equal(planes["text"],
                           dense_gus.hyperplanes(128, 8, 10, seed))
