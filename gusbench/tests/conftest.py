import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT / "src"))

# the cells at a size the CPU runs in seconds: the same code paths, a
# corpus of 2,000 points over 16 partitions, 64-id bulk RPCs
TINY = {"config": {"corpus": {"n_points": 2000},
                   "index": {"n_partitions": 16}}}
TINY_BULK = {**TINY, "traffic": {"cycle": [{"rpc": "query", "ids": 64,
                                            "k": 10}]}}

# a mutation cell that no entry of BENCHMARK.json has (the program's
# stream fails it, PERF.md, Open questions): 3 of 4 requests 16-id
# neighborhood RPCs, 1 a mutation batch of the program's stream
RPC_MIX = {"loop": "open", "rate_per_s": 40.0,
           "mix": [{"rpc": "query", "share": 3, "ids": 16, "k": 10},
                   {"rpc": "mutate", "share": 1}],
           "batch": {"size": 64, "insert_frac": 0.6, "update_frac": 0.25,
                     "jitter": 0.05},
           "warmup": {"rounds": 6}, "trace_requests": 80,
           "recall_sample": 64}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def tiny():
    return TINY


@pytest.fixture
def tiny_bulk():
    return TINY_BULK


@pytest.fixture
def mutation_root(tmp_path):
    """A checkout root (``BENCHMARK.json`` and a copy of the benchmark)
    with the cell ``arxiv-index.rpc-mix`` added from new files alone;
    returns (root, benchmark directory)."""
    bench = tmp_path / "gusbench"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (bench / "traffic" / "rpc-mix.json").write_text(json.dumps(RPC_MIX))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "arxiv-index.rpc-mix",
                              "config": "arxiv-index", "traffic": "rpc-mix",
                              "chips": 1, "why": "x"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "arxiv-index.reads" in m.get("workloads", ()):
            m["workloads"].append("arxiv-index.rpc-mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path, bench
